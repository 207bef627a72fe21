"""Work lists of halo messages moved by rows, and their launch shape.

The exchange carriers, B6 (``remote_dma.remote_axis``) and B7
(``fused_stencil.fused_exchange``), share one device body,
``csrc/row_moves.cuh``, and the fused step's phase A (``csrc/fused_jacobi.cu``)
reads the same rows. A message copies a box of a sender block's compute
cells into a box of a receiver block's halo; it moves by rows, and
:func:`message_rows` splits each box into segments of alike rows:

- a run segment: rows of one box, each ``units`` units of ``width`` words,
  16-byte vectors where source and destination agree in phase on the
  16-byte grid (with a one-word head and tail in their own segments), one
  word at a time elsewhere;
- a paired segment: the rows of two boxes with the same rows, the first
  box's ``split`` words and then the partner's, one word a unit. The
  carriers pair the +x and -x messages, so each row's hand-offs to and from
  the same 32-byte sectors sit on adjacent lanes of one warp instruction.

:func:`move_work` lays the segments out as the kernel's table
(``MOVE_COLS`` int64 a row) over the pointer groups of the boxes' steps,
each segment flagged ``narrow`` when its box's messages cross between
positions under a narrowed wire (``csrc/wire_round.cuh``: the kernel rounds
those words between load and store); :func:`launch_moves` uploads it with
the pointer rows (:func:`pointer_rows`; a sender instance whose messages
stay on its position, as between the residents of an oversubscribed mesh,
marked local there), once per geometry, wire and set of block addresses,
and launches a carrier's entry with the launch's wire code and format. On
an uneven ring the blocks differ only in where their hi side
starts along the phase axis; every instance shares the work list's box
coordinates, and the pointer of the block whose hi side a box touches is
moved by that block's offset, so the kernel and the work list stay those
of a uniform ring.
The launch shape (:func:`move_shape`) is mirrored from the header, so the
CPU tests hold the work lists to the plain versions.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from . import _native
from .halo_fill import wire_params

# csrc/row_moves.cuh: THREADS, UNROLL, COLS
MOVE_THREADS = 128
MOVE_UNROLL = 1
MOVE_COLS = 14
WARP = 32
VECTOR_BYTES = 16
SECTOR_BYTES = 32


@dataclass(frozen=True)
class RowSegment:
    """Rows of one message box that move alike: ``rows`` rows (``ey`` a
    plane), each ``units`` units of ``width`` words (``16 / word``: one
    16-byte vector; 1: one word), the first unit of the first row at word
    ``src`` (source) and ``dst`` (destination) of a position's block; row
    ``r`` lies ``(r // ey) * sz + (r % ey) * sy`` words further. A paired
    segment (``partner`` >= 0) holds the rows of two boxes: a row's first
    ``split`` units are box ``box``'s, the rest box ``partner``'s, from
    ``src2`` to ``dst2``."""

    box: int
    src: int
    dst: int
    units: int
    width: int
    ey: int
    rows: int
    partner: int = -1
    split: int = 0
    src2: int = 0
    dst2: int = 0


def _start(corner, sz: int, sy: int) -> int:
    return corner[0] * sz + corner[1] * sy + corner[2]


def message_rows(boxes, sz: int, sy: int, vec: bool, word: int = 4,
                 pairs: Sequence[Tuple[int, int]] = ()) -> List[RowSegment]:
    """The work list of the ``(src, dst, shape)`` message boxes of a block
    with plane stride ``sz`` and row stride ``sy`` (in ``word``-byte words):
    each box's rows as one segment of one-word units, or, where ``vec``
    (every pointer on the 16-byte grid, ``sz`` and ``sy`` multiples of a
    vector) and source and destination agree in phase, as a one-word head
    up to the source's 16-byte grid, a body of 16-byte vectors and a
    one-word tail. Each ``(a, b)`` of ``pairs`` (boxes with the same rows)
    is one paired segment in ``a``'s place. Empty segments are left out."""
    vw = VECTOR_BYTES // word
    if vec and (sz % vw or sy % vw):
        raise ValueError(f"strides ({sz}, {sy}) are not on the 16-byte grid")
    partner = dict(pairs)
    segs = []
    for b, (src, dst, (ez, ey, ex)) in enumerate(boxes):
        if b in partner.values():
            continue
        s0, d0 = _start(src, sz, sy), _start(dst, sz, sy)
        if b in partner:
            c = partner[b]
            csrc, cdst, (cz, cy, cx) = boxes[c]
            if (cz, cy) != (ez, ey):
                raise ValueError(f"boxes {b} and {c} do not share their rows")
            segs.append(RowSegment(b, s0, d0, ex + cx, 1, ey, ez * ey, c, ex,
                                   _start(csrc, sz, sy), _start(cdst, sz, sy)))
            continue
        parts = [(0, ex, 1)]
        head = -s0 % vw
        if vec and (s0 - d0) % vw == 0 and ex - head >= vw:
            nv = (ex - head) // vw
            parts = [(0, head, 1), (head, nv, vw), (head + vw * nv, ex - head - vw * nv, 1)]
        segs += [RowSegment(b, s0 + x, d0 + x, units, width, ey, ez * ey)
                 for x, units, width in parts if units]
    return segs


def move_shape() -> dict:
    """The carriers' launch shape (``csrc/row_moves.cuh``): threads a block,
    units each thread loads before it stores, units a task; the grid is one
    block a task, a segment's tasks chunk-major over its instances."""
    return {"threads": MOVE_THREADS, "unroll": MOVE_UNROLL,
            "task_units": MOVE_THREADS * MOVE_UNROLL}


def row_lanes(units: int) -> int:
    """Lanes a paired row of ``units`` words takes: ``units`` rounded up to
    a divisor of the warp (a power of two), so its hand-offs share one warp
    instruction; a row wider than a warp takes its own width."""
    return units if units > WARP else 1 << (units - 1).bit_length()


def narrow_flags(narrow, nboxes: int) -> Tuple[bool, ...]:
    """One bool a box, from ``narrow`` (one a box; empty: none narrows)."""
    flags = tuple(bool(f) for f in narrow) or (False,) * nboxes
    if len(flags) != nboxes:
        raise ValueError(f"{len(flags)} narrow flags for {nboxes} boxes")
    return flags


@dataclass(frozen=True)
class MoveWork:
    """A work list as the kernel reads it: ``rows``, one tuple of
    :data:`MOVE_COLS` ints a segment (group, src, dst, split, src2, dst2,
    end, units, width, ey, rows, chunks, start, narrow), ``chunks`` tasks
    per instance and ``start`` tasks before it over all ``m`` instances of
    its group (task ``start + c * m + j`` is chunk ``c`` of instance ``j``),
    ``narrow`` 1 where the segment's words round through the wire;
    ``steps``, each pointer group's (dx, dy, dz) step; ``tasks`` in all."""

    rows: tuple
    steps: tuple
    tasks: int


@functools.lru_cache(maxsize=128)
def move_work(boxes, steps, sz: int, sy: int, vec: bool, word: int, pairs, m: int,
              narrow=()) -> MoveWork:
    """The work list of the ``(src, dst, shape)`` boxes, box ``b`` sent by
    each sender to the block at its position + ``steps[b]``, for ``m``
    instances (positions x quantities) a box. Every box that is not the
    partner of a pair has a pointer group; a partner's message reads the
    group's second block and writes its first. A paired row takes
    :func:`row_lanes` units, so it lies in one warp instruction. ``narrow``
    (one bool a box; empty: none) flags the boxes whose words round
    through the wire; the two boxes of a pair share one flag."""
    segs = message_rows(boxes, sz, sy, vec, word, pairs)
    flags = narrow_flags(narrow, len(boxes))
    for a, b in pairs:
        if flags[a] != flags[b]:
            raise ValueError(f"paired boxes {a} and {b} must share their narrow flag")
    partners = {c for _b, c in pairs}
    own = [b for b in range(len(boxes)) if b not in partners]
    group = {b: g for g, b in enumerate(own)}
    task = MOVE_THREADS * MOVE_UNROLL
    rows, start = [], 0
    for s in segs:
        lanes = row_lanes(s.units) if s.partner >= 0 else s.units
        n = s.rows * lanes
        if n >= 1 << 32:
            raise ValueError(f"a segment of {n} units: the kernel counts them in 32 bits")
        chunks = -(-n // task)
        second = (s.split, s.src2, s.dst2) if s.partner >= 0 else (s.units, s.src, s.dst)
        rows.append((group[s.box], s.src, s.dst, *second, s.units, lanes, s.width, s.ey,
                     s.rows, chunks, start, int(flags[s.box])))
        start += m * chunks
    return MoveWork(tuple(rows), tuple(steps[b] for b in own), start)


def pointer_rows(ptrs, nq: int, mesh, steps, word: int, shifts=None, local=None) -> List[int]:
    """The pointer table of a launch: for each group's step and each sender
    position and quantity, (sender block, block at the sender's position +
    step), from ``ptrs`` (position-major, then quantity). ``shifts`` maps a
    step to ``(sender, receiver)``, each None or one word offset a position
    (flat order), added to the pointer of that group's sender block or, by
    the receiver's position, of its receiver block: the uneven ring's hi
    sides (``remote_dma.remote_axis_shifts``). ``local`` maps a step to one
    bool a sender position (flat order): where set, bit 0 of the sender
    pointer marks the instance's messages of that group local, so a
    narrowed wire leaves them bit copies (``csrc/row_moves.cuh``)."""
    rows = []
    for step in steps:
        dests = mesh.destinations(step)
        s_off, r_off = (shifts or {}).get(step, (None, None))
        marks = (local or {}).get(step)
        for i in range(len(mesh)):
            mark = 1 if marks is not None and marks[i] else 0
            for q in range(nq):
                rows += [(ptrs[i * nq + q] + (word * s_off[i] if s_off else 0)) | mark,
                         ptrs[dests[i] * nq + q] + (word * r_off[dests[i]] if r_off else 0)]
    return rows


def launch_moves(entry, name: str, geometry, work_of, blocks_by_position, mesh, sz: int,
                 sy: int, dev, wire=None, shifts_of=None, local=None) -> int:
    """Call a carrier's C entry (``remote_axis_launch`` or
    ``fused_exchange_launch``) for the group of ``blocks_by_position``
    through the wire format ``wire`` (``halo_fill.wire_format`` of the
    group's dtype; None copies bits); ``work_of(vec, word, m)`` gives the
    work list of ``geometry`` (which, with the mesh, the quantities, the
    word and the wire, must determine it). ``shifts_of()`` gives the shifts
    (see :func:`pointer_rows`) that move the pointers of an uneven ring's
    hi sides, which ``geometry`` must also determine; it keeps one launch
    per call. ``local`` (hashable: ``((step, flags), ...)``) marks the
    sender instances whose messages stay on their position (see
    :func:`pointer_rows`). The first call for a geometry and set of block
    addresses chooses 16-byte units (every address the kernel is given,
    shifts included, and both strides on the 16-byte grid) and uploads one
    device table: the pointer rows (:func:`pointer_rows`), then the work
    list's rows. The table and the launch's other arguments, the wire's
    code and parameters (``halo_fill.wire_params``) among them, are kept
    together (``_native.kept``), so later calls find them by one key.
    Returns the CUDA error code."""
    nq, word = len(blocks_by_position[0]), blocks_by_position[0][0].element_size()
    ptrs = tuple(b.data_ptr() for group in blocks_by_position for b in group)
    code = 0 if wire is None else wire.code

    def make():
        shifts = shifts_of() if shifts_of is not None else {}
        moved = [p + word * (off[i // nq] if off else 0) for pair in shifts.values()
                 for off in pair for i, p in enumerate(ptrs)]
        vec = all(p % VECTOR_BYTES == 0 for p in ptrs + tuple(moved)) and \
            (sz * word) % VECTOR_BYTES == 0 and (sy * word) % VECTOR_BYTES == 0
        work = work_of(vec, word, len(ptrs))
        rows = pointer_rows(ptrs, nq, mesh, work.steps, word, shifts,
                            dict(local) if wire is not None and local else None)
        table = _native.upload(rows + [v for row in work.rows for v in row], dev)
        segs = table.data_ptr() + 8 * len(rows)
        return (table, len(ptrs), segs, len(work.rows), work.tasks, word, code,
                wire_params(wire), sz, sy)

    table, *rest = _native.kept(
        (str(dev), "row_moves", name, geometry, tuple(mesh.dim), nq, word,
         None if wire is None else wire.name, local, ptrs), make)
    return entry(table.data_ptr(), *rest, _native.stream_ptr(dev))


def sector_bytes(boxes, sz: int, sy: int, itemsize: int) -> int:
    """Bytes of the 32-byte sectors one block's messages must touch, on a
    block whose address is sector-aligned: the sectors holding the boxes'
    source words, read once, and those holding their destination words,
    written once. For row ends a few words long this is the floor a copy
    can reach: a word costs its whole sector."""
    total = 0
    for side in (0, 1):
        lo, hi = [], []
        for box in boxes:
            corner, (ez, ey, ex) = box[side], box[2]
            base = ((corner[0] + np.arange(ez, dtype=np.int64))[:, None] * sz
                    + (corner[1] + np.arange(ey, dtype=np.int64))[None, :] * sy
                    + corner[2]).ravel() * itemsize
            lo.append(base // SECTOR_BYTES)
            hi.append((base + ex * itemsize - 1) // SECTOR_BYTES + 1)
        if not lo:
            continue
        lo, hi = np.concatenate(lo), np.concatenate(hi)
        order = np.argsort(lo, kind="stable")
        lo, hi = lo[order], hi[order]
        reach = np.concatenate(([lo[0]], np.maximum.accumulate(hi)[:-1]))
        total += int(np.maximum(hi - np.maximum(lo, reach), 0).sum())
    return total * SECTOR_BYTES
