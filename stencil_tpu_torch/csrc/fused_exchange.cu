// Every direction's exact-extent halo message of the fused remote-dma
// exchange over a mesh of block positions, for every position of one device
// and a same-dtype group of quantities, in one launch.
//
// Replaces: stencil_tpu/ops/fused_stencil.py make_fused_exchange_kernel (the
// TPU's exchange-only fused carrier: stage and remote-copy every crossing
// direction's message into the neighbour's landing buffer, run the
// self-wrap hand-offs locally, wait, unpack). Python wrapper, work list and
// plain PyTorch version: stencil_tpu_torch/ops/fused_stencil.py
// (fused_exchange, fused_exchange_work, fused_exchange_plain).
//
// What it computes: for each active direction d of the plan (DIRECT26
// geometry, face -> edge -> corner), each sender block's compute cells on
// its d side, radius deep along d's nonzero axes and the block's extent on
// the others, are stored into the -d side halo box of the block at position
// + d (wrapped per axis; on an axis with one position that is the sender
// itself, a self-wrap hand-off). Together the messages fill every declared
// halo cell as the axis-composed exchange does.
//
// What bounds it on an H100: bytes, 2 * elem_size * (halo cells of the
// active directions) per block and quantity over the memory rate; and the
// 32-byte sectors those bytes lie in, which for the x faces' row ends is
// a whole sector read and a whole sector written per row end, scattered a row
// apart (fused_stencil.fused_exchange_sector_bytes).
//
// Design: the reference's ColoDomainKernel ("a single kernel for the whole
// domain using precomputed offset arrays") on row_moves.cuh, over a work
// list of the plan's direction boxes (fused_stencil.message_rows, the work
// list B8's phase A also moves): the +x and -x face messages are one paired
// segment, the two hand-offs of each row end on adjacent lanes, so one warp
// instruction reads and one writes both sectors of a boundary row; the y and
// z faces and the yz edges (compute-extent x) move as 16-byte vectors where
// source and destination agree in phase; the other edges and the corners,
// whose read and written rows differ in y or z and so share no sector, move
// one word a lane. Stores go straight into the destination's halo: no
// landing buffer, no unpack.
//
// The wire_dtype form (make_fused_exchange_kernel's narrow staging, :118):
// the segments of crossing directions (the plan's `crossing`; both x faces
// share one axis, so one flag) round each word through the wire in registers
// between load and store (wire_round.cuh); self-wrap hand-offs stay bit
// copies. Rounding is idempotent, so this equals B6's composed phases with
// the same wire bit for bit.
//
// Ordering: every message reads only compute cells, which no message
// writes, and writes only halo cells, each by exactly one message; so one
// launch needs no order among its threads.
//
// The cross-process form (fused_stencil.fused_exchange_across) is this kernel
// unchanged: each process of a mesh spread over the processes of one card
// launches over its own receivers, the work list unpaired (a paired x row
// would write the sender's block) and each pointer row pairing the source
// block (its own, or another process's mapped through CUDA IPC) with its
// receiver, so a process writes only its own memory. Before the launch its
// stream waits on an interprocess event of every process the messages cross
// to (parallel/ipc.py), the TPU kernel's barrier.

#include "row_moves.cuh"

// ptrs: device table of (sender block, block at sender + the group's
// direction) pointer rows, m rows per group of the work list; segs: device
// table of nseg work-list rows (row_moves.cuh), their tasks ending at
// `tasks`; elem_size: 4 or 8; wire: the wire code (wire_round.cuh; 0 copies
// bits) and fmt its format's parameters (halo_fill.wire_params), applied to
// the segments flagged narrow (the crossing directions); sz / sy: the padded block's plane and row strides in words. Launches on
// the current device, where every block lies.
extern "C" int fused_exchange_launch(const void* ptrs, int m, const void* segs, int nseg,
                                     long long tasks, int elem_size, int wire, const double* fmt,
                                     long long sz, long long sy, void* stream) {
  return row_moves::launch(ptrs, m, segs, nseg, tasks, elem_size, wire, fmt, sz, sy, stream);
}
