"""AXIS_COMPOSED and DIRECT26 over a mesh of block positions, by copies
between positions.

The transport of a ``HaloExchange`` whose method is ``Method.AXIS_COMPOSED``
or ``Method.DIRECT26`` over a mesh (``parallel.mesh.DeviceMesh``) of one
block a position. The JAX package moves these methods' messages by
``lax.ppermute`` inside ``shard_map``; the port's counterpart of a
``ppermute`` between positions is a copy from the sender's block into the
receiver's (the reference's colocated ``cudaMemcpy`` path, ``SURVEY.md``
section 2.3). No kernel of the remote-dma family (B6, B7) and no NCCL takes
part, so an A/B between methods times different transports.

A message round moves, for every receiver position ``r``, one box out of
the sender ``r - step`` (wrapped) into ``r``:

- AXIS_COMPOSED runs the phases x, then y, then z (the plan's
  ``axis_phases``), each over the full padded extent of the other axes, so
  edges and corners compose as in the JAX package. An axis with several
  positions is two rounds: the hi slab ``[o + n_s - rm, o + n_s)`` forward
  into the lo halo ``[o - rm, o)``, then the lo slab ``[o, o + rp)``
  backward into the hi halo ``[o + n_r, o + n_r + rp)``, each at its
  position's own size on an uneven axis (``ops/remote_dma.ring_sizes``).
  An axis with one position fills its own periodic halos through B4
  (``ops/remote_dma.self_wrap_positions``). ``axes`` subsets the phases.
- DIRECT26 runs one round per active direction of the plan's
  ``direct_phases``: the box of the direction's radius on its nonzero axes
  and of the base block size on the others (on an uneven partition each
  box starts at its position's own hi side along a +/- component, and the
  rounds run face -> edge -> corner, the JAX package's
  ``_direct26_batched_uneven``).

Within a round every read is of compute cells along the axes the round
crosses and every write of halo cells along them, so the copies of a round
may run in any order; rounds run in the plan's order.

The carriers (``batch_quantities``): on, a same-dtype group is one
message, as the JAX package's packed ``ppermute``; off, every quantity is a
message of its own. Batching sets the message count, not the copies: in
one process and on the card each quantity's box is one copy from the
sender's block straight into the receiver's, whatever the batching. Only a
gloo message (across processes on the CPU) packs its group's boxes into
one flat carrier, since it is one wire send.
``wire_dtype`` narrows each box that crosses between positions
(``ops/halo_fill.wire_round``, element by element, as the JAX package's
wire-crossing ``ppermute``): every slab of a ring phase, every direction
message (the JAX package permutes each one over the mesh), never a
self-wrap fill.

Accounting, as the JAX IR counts its ``ppermute``s: ``last_message_count``
is one a round and carrier (``ExchangePlan.collectives_per_exchange``),
``last_message_bytes`` the bytes of the boxes written, at the wire's
itemsize where a carrier narrows (``ExchangePlan.wire_bytes``); across
processes each rank counts the boxes written into its own positions.

Positions spread over several processes (``DeviceMesh.multi_process``):
each rank fills its own positions' halos. On the CPU a message to another
rank travels by gloo ``isend``/``irecv`` of the packed carrier (the tag
names the receiver position). On the card each rank pulls, as one process
does: it copies each box out of the sender's block, mapped through CUDA IPC
where another rank owns it
(``parallel/ipc.PeerBuffers``: ``pointer`` and ``cuda_view``) into its own
position. Its order, by the neighbour handshake (``parallel/ipc.
PhaseOrder``): AXIS_COMPOSED one handshake an axis phase with that axis's
ring neighbours, since a phase's slabs read the halos the neighbour filled
in the phase before; DIRECT26 one with every rank the 26 directions cross
to, before the exchange. A copy, a mapping or a handshake that fails
raises; nothing spins on a flag.

On an uneven partition a DIRECT26 box that spans the base size on a zero
axis reads a smaller sender's halo and dead pad there; across processes
on the card that part may be read while the sender's own earlier rounds
write it. Those cells land in the receiver's dead pad or in a band a later
round overwrites with a true message, which reads compute cells only, so
every halo cell ends as in one process.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from ..geometry import Dim3
from ..ops.halo_fill import axis_geom, dtype_groups, wire_format, wire_round
from ..ops.remote_dma import ring_sizes, self_wrap_positions
from .ipc import cuda_view, ordered_phases

_DIM = {"z": 0, "y": 1, "x": 2}


def _box(starts, shape) -> tuple:
    """Index tuple ``(..., z, y, x)`` of a box."""
    return (..., *(slice(a, a + w) for a, w in zip(starts, shape)))


class MessageRound(NamedTuple):
    """Receiver ``r`` takes box ``srcs[s]`` of sender ``s = r - step`` into
    box ``dsts[r]``; every box holds ``cells`` cells."""

    step: Tuple[int, int, int]
    srcs: tuple
    dsts: tuple
    cells: int


def axis_rounds(spec, mesh, axis: str) -> List[MessageRound]:
    """The two rounds of an axis phase over a ring of several positions:
    the hi slabs forward into the lo halos, then the lo slabs backward into
    the hi halos, each at its position's own size (empty sides left out)."""
    o, _base, rm, rp = axis_geom(spec, axis)
    sizes = ring_sizes(spec, axis, mesh)
    p = spec.padded()
    ext = [p.z, p.y, p.x]
    a, k = _DIM[axis], "xyz".index(axis)
    out = []
    for width, src_at, dst_at, sign in ((rm, lambda n: o + n - rm, lambda n: o - rm, 1),
                                        (rp, lambda n: o, lambda n: o + n, -1)):
        if not width:
            continue
        shape = [width if i == a else e for i, e in enumerate(ext)]

        def box(at):
            return _box([at if i == a else 0 for i in range(3)], shape)

        out.append(MessageRound(tuple(sign if i == k else 0 for i in range(3)),
                                tuple(box(src_at(n)) for n in sizes),
                                tuple(box(dst_at(n)) for n in sizes),
                                shape[0] * shape[1] * shape[2]))
    return out


def direct_rounds(spec, mesh, plan) -> List[MessageRound]:
    """One round per direction message of ``plan.direct_phases``, in its
    order: uniform boxes from the plan, or on an uneven partition each
    position's box at its own hi side along the direction's +/- axes."""
    r, off = spec.radius, spec.compute_offset()
    out = []
    for ph in plan.direct_phases:
        shape = ph.shape
        cells = shape[0] * shape[1] * shape[2]
        if ph.src is not None:
            srcs = [_box(ph.src, shape)] * len(mesh)
            dsts = [_box(ph.dst, shape)] * len(mesh)
        else:
            d = Dim3.of(ph.direction)
            srcs, dsts = [], []
            for pos in mesh.positions():
                size = spec.block_size(pos)
                src, dst = [], []
                for dc, o, n, rm in zip((d.z, d.y, d.x), (off.z, off.y, off.x),
                                        (size.z, size.y, size.x), (r.z(-1), r.y(-1), r.x(-1))):
                    src.append(o + n - rm if dc == 1 else o)
                    dst.append(o - rm if dc == 1 else o + n if dc == -1 else o)
                srcs.append(_box(src, shape))
                dsts.append(_box(dst, shape))
        out.append(MessageRound(tuple(ph.direction), tuple(srcs), tuple(dsts), cells))
    return out


class PositionsExchange:
    """The AXIS_COMPOSED or DIRECT26 transport of a ``HaloExchange`` over a
    mesh of one block a position (see the module docstring). ``state`` is
    ``{key: [stack per position]}``, each stack ``(1, 1, 1, pz, py, px)``
    (None at another process's position); in place."""

    def __init__(self, ex):
        from .exchange import Method

        self.spec, self.plan, self.mesh = ex.spec, ex.plan, ex.mesh
        self.direct = ex.method == Method.DIRECT26
        self.wire = ex.wire_dtype
        self.batch = ex.batch_quantities
        if self.direct:
            self.rounds = {None: direct_rounds(self.spec, self.mesh, self.plan)}
        else:
            self.rounds = {ph.axis: (axis_rounds(self.spec, self.mesh, ph.axis)
                                     if ph.ring > 1 else None)
                           for ph in self.plan.axis_phases if ph.active}
        # sender of each receiver, by step
        self._senders: Dict[tuple, Tuple[int, ...]] = {}
        self.last_message_count = 0
        self.last_message_bytes = 0
        self.last_transfer_count = 0  # REMOTE_DMA's kernel-issued copies: none here
        # positions of other processes on the card: the CUDA IPC buffers and
        # phase order, attached at realize
        self.peers = None
        self._views: Dict[tuple, torch.Tensor] = {}

    def senders(self, step) -> Tuple[int, ...]:
        """Flat index of position - ``step`` (wrapped) for each position."""
        if step not in self._senders:
            self._senders[step] = self.mesh.destinations(tuple(-c for c in step))
        return self._senders[step]

    def _groups(self, state, first: int) -> List[List]:
        groups = [keys for _dt, keys in dtype_groups({k: v[first] for k, v in state.items()})]
        return groups if self.batch else [[k] for keys in groups for k in keys]

    def __call__(self, state, axes=None):
        self.last_message_count = 0
        self.last_message_bytes = 0
        mesh = self.mesh
        locs = mesh.local_positions()
        groups = self._groups(state, locs[0])
        card = mesh.device.type == "cuda"  # this process's positions' one device
        if self.direct and axes is not None:
            raise ValueError("axis subsetting requires AXIS_COMPOSED")
        if mesh.multi_process and not card:
            move = self._gloo_round
        else:
            if mesh.multi_process and self.peers is None:
                raise RuntimeError("a mesh spread over processes exchanges on the card through "
                                   "the buffers DistributedDomain.realize exports "
                                   "(parallel/ipc.PeerBuffers)")
            move = self._pull_round

        def phase(axis):
            rounds = self.rounds[axis]
            for keys in groups:
                if rounds is None:  # an axis with one position: B4 on each block
                    self_wrap_positions({k: [state[k][i] for i in locs] for k in keys}, keys,
                                        self.spec, axis)
                    continue
                for rnd in rounds:
                    move(state, keys, rnd)

        if self.direct:
            if mesh.multi_process and card:
                self.peers.order.before_all()
            phase(None)
            return state
        axes_run = [a for a in self.rounds if axes is None or a in axes]
        if mesh.multi_process and card:
            ordered_phases(self.peers.order, axes_run, phase)
        else:
            for a in axes_run:
                phase(a)
        return state

    def _count(self, dtype, nq: int, rnd, receivers: int) -> None:
        """One message of a carrier of ``nq`` quantities, whose boxes land in
        ``receivers`` positions."""
        fmt = wire_format(dtype, self.wire)
        item = fmt.itemsize if fmt is not None else torch.empty((), dtype=dtype).element_size()
        self.last_message_count += 1
        self.last_message_bytes += rnd.cells * item * nq * receivers

    def _gloo_round(self, state, keys, rnd) -> None:
        """Across processes on the CPU: a local sender's boxes copied into a
        local receiver, or packed into one carrier and sent to the
        receiver's rank by gloo ``isend``; the carriers from other ranks
        arrive by ``irecv`` (tag: the receiver)."""
        dist = torch.distributed
        mesh = self.mesh
        step, srcs, dsts, _cells = rnd
        senders = self.senders(step)
        receivers = mesh.destinations(step)
        reqs, keep, landing = [], [], []
        for r in mesh.local_positions():
            s = senders[r]
            views = [state[k][r][dsts[r]] for k in keys]
            if mesh.is_local(s):
                for k, v in zip(keys, views):
                    v.copy_(wire_round(state[k][s][srcs[s]], self.wire))
                continue
            buf = torch.empty(sum(v.numel() for v in views), dtype=views[0].dtype)
            reqs.append(dist.irecv(buf, mesh.owner(s), tag=r))
            landing.append((buf, views))
        for s in mesh.local_positions():
            r = receivers[s]
            if mesh.is_local(r):
                continue
            keep.append(torch.cat([wire_round(state[k][s][srcs[s]], self.wire).reshape(-1)
                                   for k in keys]))
            reqs.append(dist.isend(keep[-1], mesh.owner(r), tag=r))
        for req in reqs:
            req.wait()
        for buf, views in landing:
            at = 0
            for v in views:
                v.copy_(buf[at:at + v.numel()].view(v.shape))
                at += v.numel()
        self._count(state[keys[0]][mesh.local_positions()[0]].dtype, len(keys), rnd,
                    len(mesh.local_positions()))

    def _view(self, state, key, i: int) -> torch.Tensor:
        """Position ``i``'s block of ``state[key]``: this rank's own, or
        another rank's mapped through CUDA IPC (views kept by buffer)."""
        if self.mesh.is_local(i):
            return state[key][i]
        q, b = self.peers.buffer_of(state[key])
        if (q, b, i) not in self._views:
            like = state[key][self.mesh.local_positions()[0]]
            self._views[(q, b, i)] = cuda_view(self.peers.pointer(i, q, b),
                                               like.numel() * like.element_size(), like)
        return self._views[(q, b, i)]

    def _pull_round(self, state, keys, rnd) -> None:
        """One process, or across processes on the card: each local receiver
        copies each quantity's box out of the sender's block (mapped through
        CUDA IPC where another rank owns it), through the wire. Across
        processes the caller has ordered the round after the senders'
        earlier work (``parallel/ipc.PhaseOrder``)."""
        mesh = self.mesh
        step, srcs, dsts, _cells = rnd
        senders = self.senders(step)
        for r in mesh.local_positions():
            s = senders[r]
            for k in keys:
                state[k][r][dsts[r]] = wire_round(self._view(state, k, s)[srcs[s]], self.wire)
        self._count(state[keys[0]][mesh.local_positions()[0]].dtype, len(keys), rnd,
                    len(mesh.local_positions()))

