"""CUDA IPC between the processes of one card, and the order of their phases.

The transport of the cross-process forms of B6 (``ops/remote_dma``), B7 and
B8 (``ops/fused_stencil``) and B9 (``ops/persistent_stencil``), and of the
copies AXIS_COMPOSED and DIRECT26 pull between positions
(``parallel/mesh_exchange``): the port's
counterpart of the reference's colocated path (``tx_ipc.cpp``,
``tx_colocated.cu:45-153``: the receiver shares its curr and next quantity
buffers, the sender's kernel reads or writes them through the mapped
pointer, events and notify messages order the two processes). The C side is
``csrc/ipc.cu`` (``cudaIpcGetMemHandle`` / ``cudaIpcOpenMemHandle`` with
``cudaIpcMemLazyEnablePeerAccess`` / ``cudaIpcCloseMemHandle``, interprocess
events and their handles).

:class:`PeerBuffers` is made at ``DistributedDomain.realize`` (a
collective): each rank exports the curr and the next stack of every
quantity of its positions (both, since the jacobi loops swap them, as the
reference's ``ColoHaloSender::swap`` does, src/tx_colocated.cu:169-176) and
one interprocess event; the handles travel over gloo, and each rank opens
the events and maps the blocks of every rank it exchanges with: its ring
neighbours (B6) and the owners of the positions its direction messages come
from or go to (B7-B9: faces, edges and corners). :meth:`PeerBuffers.add`
exports one more buffer the same way (the jacobi loops' ``sel``, whose deep
halos the persistent loop exchanges). A handle names the whole allocation
that holds a block (PyTorch's caching allocator carves blocks out of
larger segments), so every export carries the block's offset into it,
which the opener adds. :meth:`PeerBuffers.close` (also run when the
buffers are garbage-collected) unmaps what it opened and destroys its
events; every rank closes before any frees the exported blocks (a barrier
between), so no mapping outlives the memory it maps.

:class:`PhaseOrder` is the TPU kernels' neighbour barrier
(``stencil_tpu/ops/remote_dma.py:153-160``, ``fused_stencil.py:153-162``,
``persistent_stencil.py:279-289``) between launches of separate processes:
before a launch a rank records its event after its prior work, tells the
ranks it exchanges with over gloo (the reference's notify,
``tx_cuda.cuh:473-483``), and once their notices have arrived its stream
waits on their events; only then does it launch. B6 and AXIS_COMPOSED's
copies hold one handshake an axis phase with that axis's ring neighbours
(:meth:`PhaseOrder.before`); B7, B8, B9 and DIRECT26's copies one a launch
or an exchange with every rank their messages cross to
(:meth:`PhaseOrder.before_all`, which raises when the order was made
without that set of ranks). The notice comes first because
``cudaStreamWaitEvent`` waits on the newest record issued before it:
without the host order a wait could pass on the previous phase's record.
Every position of a rank lies on its one stream, so one event a rank covers
them; a rank waits on one event per neighbouring rank. No kernel spins on a
flag: without MPS the kernels of two processes time-slice on the card and
are never resident together.

Each rank's launch fills its own positions' halos (it reads its
neighbours' compute cells through the mapped pointers), so a launch of a
rank ends when its halos have landed, as the TPU kernel's ends on its
receive semaphores. That makes one handshake a launch enough: a rank reads
a neighbour's cells only after the neighbour's previous launch (whose cells
it may read) has finished, and a rank writes only its own cells, which its
neighbours read no later than the launch whose event it waits on next
(PERF.md section 6, the entries on B6 and on B7-B9 across processes, have
the argument). A launch that overwrites cells its neighbours read in the
same step or chunk (a B9 chunk of several passes, the uneven fused
schedule's sweep) takes a handshake of its own first.

A persistent loop's depth-1 tail after B9 chunks (B6's exchange, then a
sweep into the buffer every neighbour, corners included, pulled from in its
last B9 launch) takes none: B6's axis phases run x, then y, then z, and
the event a rank records for a phase follows its waits of the phases
before, so waiting on it covers the ranks that rank waited on. The x wait
covers the x neighbours' last launches, the y wait also the xy corners'
through the y neighbours' x waits, and the z wait every position within
one step on each axis (PERF.md section 6 has the argument).
"""

from __future__ import annotations

import ctypes
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import _native

HANDLE_BYTES = 64  # CUDA_IPC_HANDLE_SIZE


def _lib():
    return _native.lib("ipc")


def mem_handle(t: torch.Tensor) -> Tuple[bytes, int]:
    """``(handle, offset)`` of a CUDA tensor's storage: the handle of the
    allocation that holds it and the byte offset of ``t.data_ptr()`` in it."""
    buf = ctypes.create_string_buffer(HANDLE_BYTES)
    off = ctypes.c_longlong(0)
    _native.check(_lib().ipc_mem_handle(t.data_ptr(), buf, ctypes.byref(off)),
                  "cudaIpcGetMemHandle")
    return buf.raw, off.value


# allocations of other processes mapped into this one, by handle: [base
# address, users]. A handle is opened once a process (two live domains may
# hold blocks of one segment of a neighbour) and unmapped by its last user.
_mapped: Dict[bytes, List[int]] = {}


def open_mem(handle: bytes) -> int:
    """Map another process's allocation, or take another use of its
    mapping; returns its base address here. Raises when the open fails.
    Each call is undone by one :func:`close_mem`."""
    if handle not in _mapped:
        ptr = ctypes.c_void_p(0)
        _native.check(_lib().ipc_open_mem(handle, ctypes.byref(ptr)), "cudaIpcOpenMemHandle")
        _mapped[handle] = [ptr.value, 0]
    _mapped[handle][1] += 1
    return _mapped[handle][0]


def close_mem(handle: bytes) -> None:
    """Drop one use of a mapping; the last unmaps it."""
    entry = _mapped[handle]
    entry[1] -= 1
    if entry[1] == 0:
        del _mapped[handle]
        _native.check(_lib().ipc_close_mem(entry[0]), "cudaIpcCloseMemHandle")


def event_create() -> int:
    ev = ctypes.c_void_p(0)
    _native.check(_lib().ipc_event_create(ctypes.byref(ev)), "cudaEventCreateWithFlags")
    return ev.value


def event_handle(ev: int) -> bytes:
    buf = ctypes.create_string_buffer(HANDLE_BYTES)
    _native.check(_lib().ipc_event_handle(ev, buf), "cudaIpcGetEventHandle")
    return buf.raw


def open_event(handle: bytes) -> int:
    ev = ctypes.c_void_p(0)
    _native.check(_lib().ipc_open_event(handle, ctypes.byref(ev)), "cudaIpcOpenEventHandle")
    return ev.value


def event_destroy(ev: int) -> None:
    """Destroy an event, this process's own or an opened one."""
    _native.check(_lib().ipc_event_destroy(ev), "cudaEventDestroy")


# the gloo group of the notices, one a process group (made by the first
# PeerBuffers, a collective; later ones reuse it)
_notices = (None, None)


def notice_group():
    global _notices
    world = torch.distributed.group.WORLD
    if _notices[0] is not world:
        _notices = (world, torch.distributed.new_group(backend="gloo"))
    return _notices[1]


def cuda_view(ptr: int, nbytes: int, like: torch.Tensor) -> torch.Tensor:
    """A tensor over ``nbytes`` at device address ``ptr`` (no copy), with
    ``like``'s dtype and shape."""

    class _Mem:
        __cuda_array_interface__ = {"data": (ptr, False), "shape": (nbytes,),
                                    "typestr": "|u1", "version": 3}

    raw = torch.as_tensor(_Mem(), device=like.device)
    return raw.view(like.dtype).view(like.shape)


class CudaEvents:
    """A rank's own interprocess event and its neighbours' opened ones, on
    the current stream of ``device``."""

    def __init__(self, own: int, opened: Dict[int, int], device):
        self.own, self.opened, self.device = own, opened, device

    def record(self) -> None:
        _native.check(_lib().ipc_event_record(self.own, _native.stream_ptr(self.device)),
                      "cudaEventRecord")

    def wait(self, rank: int) -> None:
        _native.check(_lib().ipc_stream_wait(_native.stream_ptr(self.device),
                                             self.opened[rank]), "cudaStreamWaitEvent")


class GlooNotices:
    """The notify messages: one int64 per neighbour a phase over a gloo
    group, holding how many notices this pair has exchanged (checked on
    arrival: the ranks run their phases in lockstep)."""

    def __init__(self, group=None):
        self.group = group
        self.sent: Dict[int, int] = {}

    def exchange(self, ranks: Sequence[int]) -> None:
        dist = torch.distributed
        outs, ins, reqs = [], [], []
        for r in ranks:
            self.sent[r] = self.sent.get(r, 0) + 1
            outs.append(torch.tensor([self.sent[r]], dtype=torch.int64))
            ins.append(torch.zeros(1, dtype=torch.int64))
            reqs.append(dist.isend(outs[-1], r, group=self.group))
            reqs.append(dist.irecv(ins[-1], r, group=self.group))
        for q in reqs:
            q.wait()
        for r, got in zip(ranks, ins):
            if int(got) != self.sent[r]:
                raise RuntimeError(f"notice {int(got)} from process {r}, expected "
                                   f"{self.sent[r]}: the ranks' phases are out of step")


class PhaseOrder:
    """The neighbour barrier of a launch: :meth:`before` records this
    rank's event, sends its notices to the ring neighbours of an axis and
    waits for theirs, then makes the stream wait on their events
    (``events``: ``record()`` / ``wait(rank)``; ``notices``:
    ``exchange(ranks)``); :meth:`before_all` does the same with
    ``everyone``, every rank this rank's direction messages cross to (None:
    not known, and :meth:`before_all` raises). An axis (or a set) whose
    neighbours are all this rank's needs nothing."""

    def __init__(self, neighbours: Dict[str, Tuple[int, ...]], events, notices,
                 everyone: Optional[Sequence[int]] = None):
        self.neighbours, self.events, self.notices = neighbours, events, notices
        self.everyone = None if everyone is None else tuple(everyone)
        self.handshakes = 0
        # host seconds spent in the handshakes, and in their notices alone
        self.host_s = self.notice_s = 0.0

    def before(self, axis: str) -> None:
        self._handshake(self.neighbours.get(axis, ()))

    def before_all(self) -> None:
        if self.everyone is None:
            raise RuntimeError("no handshake set: this phase order was made without the ranks "
                               "the direction messages cross to (PeerBuffers' steps)")
        self._handshake(self.everyone)

    def _handshake(self, ranks: Sequence[int]) -> None:
        if not ranks:
            return
        t0 = time.perf_counter()
        self.events.record()
        t1 = time.perf_counter()
        self.notices.exchange(ranks)
        t2 = time.perf_counter()
        for r in ranks:
            self.events.wait(r)
        self.handshakes += 1
        self.notice_s += t2 - t1
        self.host_s += time.perf_counter() - t0


def _release(device, bases: Dict[Tuple[int, int, int], int], handles,
             events: List[int]) -> None:
    """:meth:`PeerBuffers.close`'s work, kept off the instance so that it
    can run as its finalizer: once the card's work is done, unmap and
    destroy."""
    torch.cuda.synchronize(device)
    for key in bases:
        close_mem(handles[key][0])
    bases.clear()
    for ev in events:
        event_destroy(ev)


def ordered_phases(order: PhaseOrder, axes: Sequence[str], launch: Callable[[str], None]) -> None:
    """Run each axis phase of ``axes``: the handshake, then its launches."""
    for axis in axes:
        order.before(axis)
        launch(axis)


class PeerBuffers:
    """The blocks of every position of a mesh spread over the processes of
    one card: this rank's own stacks and the neighbours' through CUDA IPC,
    by (quantity, buffer), and the :class:`PhaseOrder` of the exchange.
    ``buffers[(q, b)]`` is quantity ``q``'s list of per-position stacks of
    buffer ``b`` (0: curr, 1: next at realize), None at another rank's
    position; ``steps`` the (dx, dy, dz) directions of the messages B7-B9
    move, at least one (their owners' ranks are
    :attr:`PhaseOrder.everyone`). Collective: every rank makes it with the
    same keys. :meth:`close` releases its mappings and events."""

    def __init__(self, mesh, buffers: Dict[Tuple[int, int], List[Optional[torch.Tensor]]],
                 steps: Sequence[Tuple[int, int, int]]):
        if not steps:
            raise ValueError("PeerBuffers needs the directions of the messages B7-B9 move: "
                             "without them no launch of those kernels would be ordered")
        dist = torch.distributed
        self.mesh = mesh
        self.device = mesh.device
        self.local: Dict[int, Tuple[int, int, int]] = {}  # data_ptr -> (q, b, position)
        self.tensors: Dict[Tuple[int, int, int], torch.Tensor] = {}
        self.added = 0
        exports = self._exports(buffers)
        self.event = event_create()
        mine = (exports, event_handle(self.event))
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)
        self.handles = {}
        for ex, _ev in gathered:
            self.handles.update(ex)
        neighbours = {axis: mesh.neighbour_ranks(axis) for axis in "xyz"
                      if mesh.ring(axis) > 1}
        everyone = mesh.message_ranks(steps)
        # every rank this one exchanges with, whose blocks it maps
        self.ranks = sorted({r for rs in (*neighbours.values(), everyone) for r in rs})
        opened_events = {r: open_event(gathered[r][1]) for r in self.ranks}
        # the base addresses of the blocks this rank mapped, by (q, b, position)
        self._bases: Dict[Tuple[int, int, int], int] = {}
        self._finalizer = weakref.finalize(self, _release, self.device, self._bases,
                                           self.handles, [self.event, *opened_events.values()])
        self._finalizer.atexit = False  # the process's exit releases them
        events = CudaEvents(self.event, opened_events, self.device)
        self.order = PhaseOrder(neighbours, events, GlooNotices(notice_group()), everyone)
        self._map(buffers)

    def _exports(self, buffers) -> dict:
        """This rank's ``(handle, offset)`` of each local stack of
        ``buffers`` (``{(q, b): stacks}``), by ``(q, b, position)``; the
        stacks kept, and found again by their addresses."""
        exports = {}
        for (q, b), stacks in buffers.items():
            for i in self.mesh.local_positions():
                t = stacks[i]
                self.local[t.data_ptr()] = (q, b, i)
                self.tensors[(q, b, i)] = t
                exports[(q, b, i)] = mem_handle(t)
        return exports

    def _map(self, keys) -> None:
        """Map the blocks of ``keys`` of every rank this one exchanges
        with once, now."""
        for i in range(len(self.mesh)):
            if not self.mesh.is_local(i) and self.mesh.owner(i) in self.ranks:
                for (q, b) in keys:
                    self.pointer(i, q, b)

    def add(self, stacks: Sequence[Optional[torch.Tensor]]):
        """Export one more per-position list of stacks (None at another
        rank's positions), as realize exported curr and next: a buffer the
        domain does not hold, such as the persistent loop's ``sel``, whose
        deep halos it exchanges. A list already exported keeps its key.
        Collective: every rank adds the same lists in the same order.
        Returns the buffer's key; its stacks are kept until :meth:`close`."""
        known = self._found(stacks)
        if len(known) == 1 and None not in known:
            return known.pop()
        key = ("added", self.added)
        self.added += 1
        mine = self._exports({key: stacks})
        gathered = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(gathered, mine)
        for ex in gathered:
            self.handles.update(ex)
        self._map([key])
        return key

    def pointer(self, i: int, q: int, b: int) -> int:
        """Device address, in this process, of quantity ``q``'s buffer ``b``
        stack at position ``i`` (mapped on first use)."""
        if self.mesh.is_local(i):
            return self.tensors[(q, b, i)].data_ptr()
        if not self._finalizer.alive:
            raise RuntimeError("the peer buffers are closed")
        handle, off = self.handles[(q, b, i)]
        if (q, b, i) not in self._bases:
            self._bases[(q, b, i)] = open_mem(handle)
        return self._bases[(q, b, i)] + off

    def close(self) -> None:
        """Unmap the other ranks' blocks this rank mapped and destroy the
        events (its own and the opened ones); a second call does nothing.
        Every rank closes before any frees the exported buffers: close,
        then a barrier, then drop the domain."""
        self._finalizer()

    def buffer_of(self, stacks: Sequence[Optional[torch.Tensor]]) -> Tuple[int, int]:
        """``(q, b)`` of a quantity's list of per-position stacks, by the
        addresses of its local stacks, which must all be the buffers
        exported at realize or by :meth:`add`."""
        found = self._found(stacks)
        if None in found:
            raise RuntimeError(
                "a local block is not an exported buffer: a mesh spread over processes "
                "exchanges the domain's own curr and next stacks, or stacks exported by "
                "PeerBuffers.add")
        if len(found) != 1:
            raise RuntimeError(f"a quantity's positions mix exported buffers {sorted(found)}")
        return found.pop()

    def _found(self, stacks) -> set:
        """The ``(q, b)`` of each local stack of ``stacks`` exported at its
        own position, None for one that is not."""
        found = set()
        for i in self.mesh.local_positions():
            key = self.local.get(stacks[i].data_ptr())
            found.add(key[:2] if key is not None and key[2] == i else None)
        return found

    def gather(self, stacks: Sequence[Optional[torch.Tensor]]) -> Optional[List[torch.Tensor]]:
        """Every position's stack of one quantity's buffer, copied onto
        rank 0 through the mapped pointers (None on the other ranks).
        Collective: the ranks synchronize their card work before and after
        rank 0 reads."""
        dist = torch.distributed
        torch.cuda.synchronize(self.device)
        dist.barrier()
        out = None
        if self.mesh.rank == 0:
            q, b = self.buffer_of(stacks)
            like = stacks[self.mesh.local_positions()[0]]
            out = [stacks[i].clone() if self.mesh.is_local(i) else
                   cuda_view(self.pointer(i, q, b), like.numel() * like.element_size(),
                             like).clone()
                   for i in range(len(self.mesh))]
            torch.cuda.synchronize(self.device)
        dist.barrier()
        return out
