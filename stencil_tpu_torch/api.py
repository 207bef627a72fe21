"""DistributedDomain — the top-level user API.

The port's counterpart of ``stencil_tpu.api`` (reference:
include/stencil/stencil.hpp:33-225, src/stencil.cu). The surface is kept:
``set_radius`` -> ``add_data`` -> ``realize`` -> loop {compute /
``exchange`` / ``swap``}. With one device the port realizes one block (the
default), or any partition (``set_partition``), uniform or uneven (the
reference's remainder rule: trailing blocks one cell smaller along an axis),
with every block resident on the device, as the JAX package stacks
residents when a partition has more blocks than devices. With a list of N devices
(``set_devices``, which may name one card N times: the reference's
``dd.set_gpus({0,0})``, stencil.hpp:154) it realizes a mesh of N block
positions, one block per position, each its own allocation, exchanged by
``Method.REMOTE_DMA``; a count such as 6 splits 512^3 unevenly, (3,2,1) with
x blocks of 171/171/170; a pinned partition with more blocks than positions
stacks the extra blocks on each position (the JAX package's
``stack_residents``). The exchange is ``parallel.exchange.HaloExchange``:
axis-composed or direct26 on one device, or remote-dma (with its fused and
persistent kernel variants on one block a position) on one device or over
the mesh. ``set_quantity_batching``, ``run_exchanges``, ``set_output_prefix``
and ``write_plan`` (the plan and block-comm matrix files, byte for byte the
JAX package's) are the JAX package's.

The planner (``plan/``) drives a domain as in the JAX package: ``plan=`` /
:meth:`set_plan` applies a tuned :class:`~.plan.ir.PlanChoice` at realize()
as one unit (partition, method, batching, fused or persistent variant; an
explicit :meth:`set_partition` wins over it, with a warning), ``autotune=``
/ :meth:`enable_autotune` tunes one at realize() against the plan DB
``plan_db`` (``plan/autotune.py``, over this domain's device or positions),
:meth:`plan_meta` is the effective plan that checkpoint manifests record
(with the wire dtype; a resume under another plan or wire warns), and
:meth:`replan` hot-swaps the plan of a realized domain, state bit for bit.

Entry points run on the GPU unless the caller asks for the CPU:
``device=None`` means the current CUDA device and raises when none is
visible; ``device="cpu"`` runs the plain PyTorch versions of the kernels
(what the tests do).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .domain import DataHandle, GridSpec
from .geometry import (DIRECTIONS_26, Dim3, NodePartition, Radius, Rect3, exterior_regions,
                       halo_extent, interior_region, stack_residents)
from .ops.halo_fill import wire_name
from .parallel.exchange import HaloExchange, Method, direction_bytes, shard_blocks, unshard_blocks
from .parallel.mesh import DeviceMesh
from .utils import logging as log
from .utils import timer
from .utils.sync import hard_sync


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises when no GPU is visible);
    otherwise ``torch.device(device)``, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {d} requested but no CUDA device is visible")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d


class DistributedDomain:
    """A multi-quantity 3D periodic domain: every block on one device, or
    the blocks spread over the positions of a mesh (``set_devices`` with
    several entries). On a mesh each quantity's curr and next are lists of
    ``(cz, cy, cx, pz, py, px)`` stacks, one per position in the mesh's flat
    order (x fastest): one block a position, or each position's resident
    blocks when the partition has more blocks than positions."""

    def __init__(self, x: int, y: int, z: int, device=None, plan=None,
                 autotune: bool = False, plan_db: Optional[str] = None):
        self.size = Dim3(x, y, z)
        self.radius = Radius.constant(0)
        self.device = resolve_device(device)
        self._names: List[str] = []
        self._dtypes: List[torch.dtype] = []
        self._method = Method.AXIS_COMPOSED
        self._batch_quantities = True
        self._output_prefix = os.environ.get("STENCIL_OUTPUT_PREFIX", "")
        self._fused = False
        self._persistent = False
        self._wire_dtype: Optional[str] = None
        self._partition_dim: Optional[Dim3] = None
        self._devices: Optional[List[torch.device]] = None
        self.mesh: Optional[DeviceMesh] = None
        self._realized = False
        self._curr: Dict[int, torch.Tensor] = {}
        self._next: Dict[int, torch.Tensor] = {}
        self.time_realize = 0.0
        self.time_exchange = 0.0
        self.time_swap = 0.0
        self.num_exchanges = 0
        # exchange planning (plan/): an explicit tuned choice, or tuning at
        # realize() against the on-disk plan DB
        self._plan_choice = None
        self._autotune_opts: Optional[dict] = None
        self.autotune_result = None
        if plan is not None:
            self.set_plan(plan)
            if autotune:
                log.warn("explicit plan= suppresses autotune=: the given choice is applied "
                         "as it is (drop plan= to re-tune)")
        if autotune:
            self.enable_autotune(db_path=plan_db)

    # -- configuration (pre-realize) ----------------------------------------
    def set_radius(self, r) -> None:
        """Uniform or per-direction radius (reference: stencil.hpp:124-137)."""
        self.radius = Radius.constant(r) if isinstance(r, int) else r

    def add_data(self, name: str = "", dtype="float32") -> DataHandle:
        """Register a quantity (reference: stencil.hpp:128)."""
        if self._realized:
            raise RuntimeError("add_data after realize()")
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {dtype!r}")
        idx = len(self._names)
        self._names.append(name or f"data{idx}")
        self._dtypes.append(dt)
        return DataHandle(idx, self._names[-1], str(dt).replace("torch.", ""))

    def set_methods(self, method: Method) -> None:
        """Exchange strategy (reference: stencil.hpp:139): AXIS_COMPOSED,
        DIRECT26 or REMOTE_DMA."""
        if not isinstance(method, Method):
            raise NotImplementedError(
                f"{method}: the port has the axis-composed, direct26 and remote-dma exchanges")
        self._method = method

    def set_plan(self, choice) -> None:
        """Apply a tuned exchange plan (a ``plan.ir.PlanChoice`` or its JSON
        dict) at realize(): its partition, method, quantity batching and
        kernel variant as one unit. ``multistep_k`` rides along for the apps
        that own that knob (:attr:`plan_choice`). An explicit
        :meth:`set_partition` wins over the plan's partition, with a warning,
        and then none of the plan is applied. A hierarchy or a non-identity
        placement raises at realize() (ROADMAP.md queue A item 5)."""
        from .plan.ir import PlanChoice

        if isinstance(choice, dict):
            choice = PlanChoice.from_json(choice)
        self._plan_choice = choice

    def enable_autotune(self, db_path: Optional[str] = None, probe: bool = True,
                        top_n: int = 3, probe_iters: int = 4, ks: Sequence[int] = (1,),
                        force: bool = False) -> None:
        """Tune the exchange plan at realize() (``plan/autotune.autotune``
        over this domain's device or mesh positions): the plan DB first (a
        hit replays with zero probes), else the static ranking's top
        ``top_n`` timed and the winner stored in ``db_path``. The result is
        :attr:`autotune_result`."""
        self._autotune_opts = dict(db_path=db_path, probe=probe, top_n=top_n,
                                   probe_iters=probe_iters, ks=tuple(ks), force=force)

    @property
    def plan_choice(self):
        """The applied tuned choice (None on a plan-less domain)."""
        return self._plan_choice

    def set_quantity_batching(self, enabled: bool) -> None:
        """Quantity-batched exchange (default on): each message or slab of a
        same-dtype group of quantities moves as one packed carrier (one
        axis-carrier launch a phase, up to 16 blocks a fill launch), so the
        carrier count per exchange does not grow with the quantity count.
        Off, every quantity moves on its own (the A/B baseline). The cells
        are the same either way. Applied at realize()."""
        self._batch_quantities = bool(enabled)

    def set_output_prefix(self, prefix: str) -> None:
        """Prefix of the files the domain writes: realize() writes
        :meth:`write_plan`'s files under it when it is not empty (default:
        the ``STENCIL_OUTPUT_PREFIX`` environment variable)."""
        self._output_prefix = prefix

    def set_fused_exchange(self, enabled: bool) -> None:
        """The FUSED compute+exchange variant of ``Method.REMOTE_DMA``: the
        jacobi step loops run one kernel per step that hands off every
        direction's halo and sweeps (``ops/fused_stencil.py``; over a mesh of
        positions one launch covers every position). Applied at realize(),
        which raises for another method."""
        self._fused = bool(enabled)

    def set_persistent_exchange(self, enabled: bool) -> None:
        """The PERSISTENT whole-chunk variant of ``Method.REMOTE_DMA``: the
        jacobi step loops run one kernel per k-step chunk over radius-k
        halos (``ops/persistent_stencil.py``; over a mesh of positions one
        launch covers every position), so the domain must be
        realized at radius k (``jacobi3d --kernel-variant persistent
        --deep-halo k`` does this). Mutually exclusive with
        :meth:`set_fused_exchange`; applied at realize(), which raises for
        another method."""
        self._persistent = bool(enabled)

    def set_wire_dtype(self, dtype) -> None:
        """bf16-on-the-wire halo compression (``None`` or "" = off), as in the
        JAX package: halo messages that cross between mesh positions narrow
        to this dtype on the way and widen on arrival
        (``HaloExchange(wire_dtype=...)``; ``ops/halo_fill.wire_format``
        owns the policy: only floating quantities narrow, local copies stay
        lossless). LOSSY by design: the exchanged halos round to the wire
        precision. The port takes every floating format the JAX package
        does (``ops/halo_fill.WIRE_FORMATS``: bfloat16, float16, the fp8
        and fp4 formats and, for float64 data, float32); on one device it
        is a no-op. Checkpoint
        manifests record it (:meth:`plan_meta`), and a resume under another
        wire warns."""
        self._wire_dtype = wire_name(dtype)

    def set_devices(self, devices: Sequence) -> None:
        """Run on these devices (reference ``set_gpus``, stencil.hpp:154).
        One entry: every block on that device. N entries: a mesh of N block
        positions, which may name one device several times; the partition
        is ``NodePartition(size, radius, 1, N)`` unless ``set_partition``
        pins one (a multiple of N blocks stacks residents on each position,
        z first), and the exchange is ``Method.REMOTE_DMA``. Positions on
        distinct GPUs are refused at realize() (ROADMAP.md queue A item
        5)."""
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("set_devices needs at least one device")
        self.device = devices[0]
        self._devices = devices if len(devices) > 1 else None

    def set_partition(self, dim) -> None:
        """Pin the partition grid (blocks along x, y, z): every block
        resident on the one device, or spread over the positions of a mesh
        (one block each, or each position's stack of residents when the
        partition has a multiple of their number). Any partition
        ``GridSpec`` takes, uneven included: an axis that the block count
        does not divide gives its trailing blocks one cell less."""
        dim = Dim3.of(dim)
        GridSpec(self.size, dim, Radius.constant(0))  # raises for an impossible split
        self._partition_dim = dim

    # -- realize -------------------------------------------------------------
    def realize(self) -> None:
        """Partition, allocate every quantity's curr/next block, and build
        the exchange (reference: src/stencil.cu:241-850)."""
        t0 = time.perf_counter()
        with timer.timed("setup.realize"), timer.trace_range("stencil.realize"):
            n = len(self._devices) if self._devices else 1
            self._apply_plan()
            dim = self._partition_dim or NodePartition(self.size, self.radius, 1, n).dim()
            self.spec = GridSpec(self.size, dim, self.radius)
            if self._devices:
                # one block per position, or (a multiple of the positions)
                # each position's resident stack, stacked z-heaviest first
                mesh_dim = dim
                if dim.flatten() != n:
                    c, rem = divmod(dim.flatten(), n)
                    if rem:
                        raise ValueError(f"partition {dim} has {dim.flatten()} blocks, not a "
                                         f"multiple of {n} devices")
                    mesh_dim = stack_residents(dim, c)
                self.mesh = DeviceMesh(mesh_dim, self._devices)
            self._exchange = HaloExchange(self.spec, self._method, fused=self._fused,
                                          persistent=self._persistent, mesh=self.mesh,
                                          wire_dtype=self._wire_dtype,
                                          batch_quantities=self._batch_quantities)
            for idx, dt in enumerate(self._dtypes):
                self._curr[idx] = self._zeros(dt)
                self._next[idx] = self._zeros(dt)
        self.time_realize = time.perf_counter() - t0
        self._realized = True
        log.debug(f"realized {self.size} over {dim} blocks of {self.spec.base}, "
                  f"padded {self.spec.padded()} on {self.device}")
        if self._output_prefix:
            self.write_plan(self._output_prefix)

    def _apply_plan(self) -> None:
        """Tune when asked, then apply the tuned choice as one unit (the
        JAX package's realize())."""
        if self._autotune_opts is not None and self._plan_choice is None:
            if not self._dtypes:
                log.warn("autotune: no quantities declared; skipping")
            else:
                from .plan.autotune import autotune as _plan_autotune

                opts = self._autotune_opts
                self.autotune_result = _plan_autotune(
                    self.size, self.radius, self._dtype_names(),
                    devices=self._devices or [self.device], db_path=opts["db_path"],
                    probe=opts["probe"], top_n=opts["top_n"], probe_iters=opts["probe_iters"],
                    ks=opts["ks"], force=opts["force"])
                self._plan_choice = self.autotune_result.choice
        ch = self._plan_choice
        if ch is None:
            return
        ch.realizable()
        if self._partition_dim is not None and self._partition_dim != Dim3.of(ch.partition):
            # the choice was tuned as a unit: an explicit partition overrides
            # the whole plan, not pieces of it
            log.warn(f"explicit partition {self._partition_dim} overrides the tuned plan "
                     f"{ch.label()}; the plan's method and batching are NOT applied (re-tune "
                     "with the pinned partition instead)")
            self._plan_choice = None
            return
        self._method = Method(ch.method)
        self._batch_quantities = ch.batch_quantities
        # the choice owns the variant both ways: a plain choice clears an
        # earlier set_fused_exchange(True)
        self._fused = ch.is_fused
        self._persistent = ch.is_persistent
        if self._partition_dim is None:
            self._partition_dim = Dim3.of(ch.partition)

    def _zeros(self, dtype):
        """A zero quantity: the stacked tensor, or a mesh's stacks."""
        if self.mesh is None:
            return torch.zeros(self.spec.stacked_shape_zyx(), dtype=dtype, device=self.device)
        p, c = self.spec.padded(), self._exchange.resident
        return [torch.zeros((c.z, c.y, c.x, p.z, p.y, p.x), dtype=dtype, device=d)
                for d in self.mesh.devices]

    # -- data access ---------------------------------------------------------
    def get_curr(self, h: DataHandle) -> torch.Tensor:
        return self._curr[h.idx]

    def get_next(self, h: DataHandle) -> torch.Tensor:
        return self._next[h.idx]

    def set_curr(self, h: DataHandle, stacked: torch.Tensor) -> None:
        self._curr[h.idx] = stacked

    def set_next(self, h: DataHandle, stacked: torch.Tensor) -> None:
        self._next[h.idx] = stacked

    def curr_state(self) -> Dict[int, torch.Tensor]:
        return dict(self._curr)

    def next_state(self) -> Dict[int, torch.Tensor]:
        return dict(self._next)

    def set_curr_global(self, h: DataHandle, global_zyx: np.ndarray) -> None:
        """Scatter a host array [z,y,x] into the padded block layout (a
        mesh's blocks on a mesh)."""
        dt = self._dtypes[h.idx]
        np_dt = torch.empty((), dtype=dt).numpy().dtype
        self._curr[h.idx] = shard_blocks(global_zyx.astype(np_dt), self.spec,
                                         self.mesh or self.device)

    def get_curr_global(self, h: DataHandle) -> np.ndarray:
        """Gather the compute region to a host array [z,y,x] (from every
        position on a mesh)."""
        return unshard_blocks(self._curr[h.idx], self.spec)

    # -- the iteration API (reference: stencil.hpp:182-215) ------------------
    @property
    def halo_exchange(self) -> HaloExchange:
        return self._exchange

    def exchange(self) -> None:
        """Fill every halo from the periodic neighbours, in place, and wait
        for the device (reference: src/stencil.cu:1002-1186)."""
        t0 = time.perf_counter()
        with timer.timed("exchange"), timer.trace_range("stencil.exchange"):
            self._exchange(self._curr)
            hard_sync(self.device)
        self.time_exchange += time.perf_counter() - t0
        self.num_exchanges += 1

    def exchange_loop(self, iters: int):
        """``loop(state) -> state``: ``iters`` back-to-back exchanges over a
        quantity dict (see :meth:`curr_state`); does not synchronize."""
        return self._exchange.make_loop(iters)

    def run_exchanges(self, iters: int) -> None:
        """Run ``iters`` back-to-back exchanges on the domain's current
        state and wait for the device."""
        t0 = time.perf_counter()
        with timer.timed("exchange"), timer.trace_range("stencil.exchange_loop"):
            self.exchange_loop(iters)(self._curr)
            hard_sync(self.device)
        self.time_exchange += time.perf_counter() - t0
        self.num_exchanges += iters

    def swap(self) -> None:
        """Swap curr/next (reference: src/stencil.cu:852-872)."""
        t0 = time.perf_counter()
        self._curr, self._next = self._next, self._curr
        self.time_swap += time.perf_counter() - t0

    def _computes(self) -> List[Rect3]:
        """Each block's compute region, allocation-local, in block order
        i -> (i % dx, (i // dx) % dy, i // (dx * dy))."""
        d, off = self.spec.dim, self.spec.compute_offset()
        return [Rect3(off, off + self.spec.block_size((i % d.x, (i // d.x) % d.y,
                                                       i // (d.x * d.y))))
                for i in range(self.spec.num_blocks())]

    def get_interior(self) -> List[Rect3]:
        """Per-block interior compute region, allocation-local coordinates
        (reference: src/stencil.cu:878-921)."""
        return [interior_region(c, self.radius) for c in self._computes()]

    def get_exterior(self) -> List[List[Rect3]]:
        """Per-block exterior slabs (reference: src/stencil.cu:927-977)."""
        return [exterior_regions(c, interior_region(c, self.radius))
                for c in self._computes()]

    # -- observability -------------------------------------------------------
    def write_plan(self, prefix: str) -> None:
        """Write the exchange plan (``{prefix}plan_0.txt``) and the
        block-to-block byte matrix (``{prefix}mat_npy_loadtxt.txt``, for
        numpy's loadtxt), the same files, byte for byte, as the JAX package
        writes for the same domain (reference: src/stencil.cu:482-637)."""
        md = self.mesh.dim if self.mesh is not None else Dim3(1, 1, 1)
        itemsizes = self._itemsizes()
        with open(f"{prefix}plan_0.txt", "w") as f:
            f.write(f"global {self.size} dim {self.spec.dim} base {self.spec.base}\n")
            f.write(f"radius {self.radius}\n")
            f.write(f"method {self._method.value}\n")
            f.write(f"mesh {dict(z=md.z, y=md.y, x=md.x)}\n")
            for d in DIRECTIONS_26:
                b = direction_bytes(self.spec, d, sum(itemsizes))
                f.write(f"dir ({d.x},{d.y},{d.z}) bytes {b}\n")
        d = self.spec.dim
        nb = self.spec.num_blocks()
        mat = np.zeros((nb, nb), dtype=np.int64)
        for i in range(nb):
            src = Dim3(i % d.x, (i // d.x) % d.y, i // (d.x * d.y))
            for dd in DIRECTIONS_26:
                if self.radius.dir(dd) == 0:
                    continue
                dst = (src + dd).wrap(d)
                j = dst.x + dst.y * d.x + dst.z * d.x * d.y
                ext = halo_extent(dd, self.spec.block_size(src), self.radius)
                mat[i, j] += ext.flatten() * sum(itemsizes)
        np.savetxt(f"{prefix}mat_npy_loadtxt.txt", mat, fmt="%d")

    # -- accounting (reference: src/stencil.cu:139-161) ----------------------
    def _itemsizes(self) -> List[int]:
        return [torch.empty((), dtype=dt).element_size() for dt in self._dtypes]

    def exchange_bytes_for_method(self, method: Method) -> int:
        """Logical halo bytes per exchange attributed to ``method``."""
        if method != self._method:
            return 0
        return self._exchange.bytes_logical(self._itemsizes())

    def exchange_bytes_moved(self) -> int:
        return self._exchange.bytes_moved(self._itemsizes())

    # -- the plan (plan/) -----------------------------------------------------
    def plan_meta(self) -> dict:
        """The effective exchange plan of the realized domain, what the
        checkpoint manifests record (``meta.plan``) so that a resume can warn
        when a snapshot tuned under one plan or wire is revived under another
        (the state restores bit for bit either way). ``host_blocks`` is the
        host of each mesh position: all 0, one card."""
        from .plan.ir import FUSED_VARIANT, PERSISTENT_VARIANT, PlanChoice, PlanConfig

        if not self._realized:
            raise RuntimeError("plan_meta requires realize()")
        n = len(self.mesh) if self.mesh is not None else 1
        cfg = PlanConfig.make(self.size, self.radius, self._dtype_names(), n, self.device.type)
        ch = self._plan_choice
        choice = PlanChoice(
            partition=(self.spec.dim.x, self.spec.dim.y, self.spec.dim.z),
            method=self._method.value, batch_quantities=self._batch_quantities,
            multistep_k=ch.multistep_k if ch is not None else 1,
            kernel_variant=(ch.kernel_variant if ch is not None
                            else FUSED_VARIANT if self._fused
                            else PERSISTENT_VARIANT if self._persistent else None),
            placement=ch.placement if ch is not None else None)
        return {"key": cfg.to_json(), "choice": choice.to_json(), "tuned": ch is not None,
                "wire_dtype": self._wire_dtype, "host_blocks": [0] * n}

    def _warn_plan_mismatch(self, manifest: dict) -> None:
        """Warn when the snapshot's plan or wire differs from this domain's
        (the JAX package's rules: absent fields are identity / flat; an
        untuned partition-only change is the supported elastic resume)."""
        saved = (manifest.get("meta") or {}).get("plan")
        if not saved:
            return  # a snapshot written without a plan: nothing to compare
        here = self.plan_meta()
        saved_ch = dict(saved.get("choice") or {})
        here_ch = dict(here["choice"])
        for k in ("placement", "hierarchy", "host_placement"):
            saved_ch.setdefault(k, None)
            here_ch.setdefault(k, None)
        saved_hosts = saved.get("host_blocks")
        if saved_hosts is not None and saved_hosts != here.get("host_blocks"):
            log.warn(f"ckpt: snapshot was written on host fabric {saved_hosts} but this run "
                     f"realizes {here.get('host_blocks')} (host index per mesh position) - "
                     "the elastic restore is bit-exact, but exchange timings differ")
        if not (saved.get("tuned") or here["tuned"]):
            for k in ("partition", "placement"):
                saved_ch.pop(k, None)
                here_ch.pop(k, None)
        saved_m, here_m = saved_ch.get("method"), here_ch.get("method")
        known = {m.value for m in Method}
        unknown = (f" (method {saved_m!r} is unknown to this build)"
                   if saved_m is not None and saved_m not in known else "")
        wire_delta = saved.get("wire_dtype") != here.get("wire_dtype")
        if saved_ch != here_ch or wire_delta:
            detail = f" (exchange method {saved_m} -> {here_m})" if saved_m != here_m else ""
            if wire_delta:
                detail += (f" (wire_dtype {saved.get('wire_dtype')} -> {here.get('wire_dtype')}: "
                           "halos exchanged after restore round to the NEW wire precision)")
            log.warn(f"ckpt: snapshot was written under exchange plan {saved.get('choice')} "
                     f"but this run uses {here['choice']}{detail}{unknown} - the elastic "
                     "restore is still bit-exact, but the programs differ; re-tune "
                     "(--autotune) or pass the snapshot's plan to keep measurements comparable")

    def replan(self, choice) -> None:
        """Hot-swap the exchange plan of a realized domain, in place: what
        ``plan/replan.ReplanController`` calls between guarded-loop chunks.
        ``choice`` (a ``PlanChoice`` or its JSON dict) is applied as a unit,
        any explicit partition cleared. Every quantity's compute region is
        gathered to the host, the domain re-realized under the new plan, the
        regions scattered back and every halo rebuilt by one exchange: the
        state after the swap equals the state before it, bit for bit. If the
        new choice fails to realize, the old plan is put back (with the
        gathered state) and the error re-raised."""
        from .plan.ir import PlanChoice

        if not self._realized:
            raise RuntimeError("replan() requires a realized domain (use set_plan before "
                               "realize() for the initial choice)")
        if isinstance(choice, dict):
            choice = PlanChoice.from_json(choice)
        with timer.timed("setup.replan"), timer.trace_range("stencil.replan"):
            globs = {idx: unshard_blocks(self._curr[idx], self.spec) for idx in self._curr}
            old = (self._plan_choice, self._partition_dim, self._method,
                   self._batch_quantities, self._fused, self._persistent)

            def install(ch):
                self._plan_choice = ch
                self._realized = False
                self._curr, self._next = {}, {}
                self.realize()
                for idx, g in globs.items():
                    self.set_curr_global(DataHandle(idx, self._names[idx], ""), g)
                if self.radius.max_radius() > 0:
                    self.exchange()

            self._partition_dim = None
            try:
                install(choice)
            except Exception:
                (_ch, self._partition_dim, self._method, self._batch_quantities, self._fused,
                 self._persistent) = old
                install(old[0])
                raise

    # -- checkpoint / restart (ckpt/) ----------------------------------------
    # One process holds every block, so there is no multi-process branch:
    # per-process shards and a manifest merge come with processes and hosts
    # (ROADMAP.md queue A item 5).
    def _dtype_names(self) -> List[str]:
        return [str(dt).replace("torch.", "") for dt in self._dtypes]

    def save_checkpoint(self, ckpt_dir: str, step: int, *, keep: int = 3,
                        asynchronous: bool = True) -> None:
        """Snapshot every quantity's ``curr`` state at ``step`` into
        ``ckpt_dir`` (per-block npz + manifest, the crash-safe rename
        protocol of ``ckpt/snapshot.py``, the JAX package's format).

        ``asynchronous=True`` (default) copies the state to the host on this
        thread, then hashes, serializes and fsyncs on a writer thread so the
        step loop keeps running; a second save drains the first. Call
        :meth:`finish_checkpoints` before exiting."""
        from .ckpt import AsyncCheckpointer, host_snapshot, write_snapshot

        arrays = {name: self._curr[i] for i, name in enumerate(self._names)}
        dtypes = dict(zip(self._names, self._dtype_names()))
        extra_meta = {"plan": self.plan_meta()}
        if not asynchronous:
            with timer.timed("ckpt.save"), timer.trace_range("ckpt.save"):
                write_snapshot(ckpt_dir, step, self.spec, host_snapshot(self.spec, arrays),
                               dtypes=dtypes, keep=keep, extra_meta=extra_meta)
            return
        cp = getattr(self, "_checkpointer", None)
        if cp is None or cp.ckpt_dir != ckpt_dir:
            if cp is not None:
                cp.close()
            cp = self._checkpointer = AsyncCheckpointer(ckpt_dir, keep=keep, dtypes=dtypes)
        cp.keep = keep
        cp.save(self.spec, arrays, step, extra_meta=extra_meta)

    def flush_checkpoints(self) -> None:
        """Block until the in-flight async snapshot (if any) is durable,
        keeping the writer alive: what the recovery engine calls before it
        reads the checkpoint dir back (a rollback restore, the
        ckpt-truncate injection)."""
        cp = getattr(self, "_checkpointer", None)
        if cp is not None:
            cp.flush()

    def finish_checkpoints(self) -> None:
        """Drain and stop the async writer: every handed-off snapshot is
        durable when this returns."""
        cp = getattr(self, "_checkpointer", None)
        if cp is not None:
            cp.close()
            self._checkpointer = None

    def restore_checkpoint(self, ckpt_dir: str) -> Optional[int]:
        """Load the newest valid snapshot under ``ckpt_dir`` that fits this
        domain (global size, quantity names and dtypes) into every
        quantity's ``curr``, then exchange once. Elastic: the snapshot's
        partition, mesh or package may differ from this domain's (global
        reassembly, re-split by :meth:`set_curr_global`). Returns the
        restored step, or None when no compatible snapshot exists (logged,
        never raised: a resume then starts fresh)."""
        from .ckpt import assemble_global, check_compatible, find_resume
        from .obs import telemetry

        if not self._realized:
            raise RuntimeError("restore_checkpoint requires realize()")
        found = find_resume(ckpt_dir, accept=lambda m: check_compatible(
            m, self.size, self._names, self._dtype_names()))
        if found is None:
            log.info(f"ckpt: no valid compatible snapshot under {ckpt_dir}")
            return None
        snap, manifest = found
        # restoring under another plan is legal (the restore is elastic);
        # say so, so that measurements stay attributable
        self._warn_plan_mismatch(manifest)
        rec = telemetry.get()
        with rec.span("ckpt.restore", phase="ckpt", step=manifest["step"]):
            nbytes = 0
            for idx, (name, dt) in enumerate(zip(self._names, self._dtype_names())):
                g = assemble_global(snap, manifest, name, dtype=np.dtype(dt))
                nbytes += g.nbytes
                self.set_curr_global(DataHandle(idx, name, dt), g)
            if self.radius.max_radius() > 0:
                # every halo rebuilt on this domain's partition: the restored
                # state is then indistinguishable from a live one
                self.exchange()
        rec.counter("ckpt.bytes_read", bytes=nbytes, phase="ckpt", step=manifest["step"])
        rec.meta("ckpt.resumed", step=manifest["step"], snapshot=snap)
        log.info(f"ckpt: restored step {manifest['step']} from {snap}")
        return manifest["step"]

    # -- numerical health (fault/) -------------------------------------------
    def check_health(self, max_abs: Optional[float] = None,
                     step: Optional[int] = None) -> None:
        """One health check (every quantity's ``curr`` all finite, and max
        |u| under ``max_abs`` when given), one launch of the health
        kernel on the card; raises :class:`~.fault.NumericalFault` naming
        the offending quantity. The loop-integrated form (periodic checks
        and rollback) is :func:`~.fault.run_guarded`, the apps'
        ``--health-every`` / ``--max-rollbacks``."""
        from .fault.health import HealthGuard

        if not self._realized:
            raise RuntimeError("check_health requires realize()")
        g = getattr(self, "_health_guard", None)
        if g is None:
            g = self._health_guard = HealthGuard(every=1)
        g.max_abs = float(max_abs) if max_abs else None
        g.check({self._names[i]: a for i, a in self._curr.items()},
                step=-1 if step is None else int(step))
