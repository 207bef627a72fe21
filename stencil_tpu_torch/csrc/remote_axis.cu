// One axis phase of the remote-dma halo exchange over a mesh of block
// positions, for every position of one device and a same-dtype group of
// quantities, in one launch.
//
// Replaces: stencil_tpu/ops/remote_dma.py make_remote_axis_kernel (the TPU
// carrier kernel: neighbour barrier, stage both boundary slabs of a packed
// Q-quantity carrier into VMEM, remote-copy them into the ring neighbours'
// landing buffers, wait, unpack into the halos). Python wrapper, work list
// and plain PyTorch version: stencil_tpu_torch/ops/remote_dma.py
// (remote_axis, remote_axis_work, remote_axis_plain).
//
// What it computes: along the phase axis, with compute offset o, block size
// n and halo widths rm / rp, each sender block's hi boundary slab
// [o + n - rm, o + n) is stored into its forward neighbour's lo halo
// [o - rm, o), and its lo slab [o, o + rp) into its backward neighbour's hi
// halo [o + n, o + n + rp). A slab spans the FULL padded extent of the other
// two axes, so running the phases x, then y, then z composes edges and
// corners as the axis-composed exchange does.
//
// What bounds it on an H100: bytes, 2 * elem_size * (rm + rp) * (product of
// the other two padded extents) per block and quantity over the memory rate;
// and in the x phase the 32-byte sectors those bytes lie in. An x slab's row
// is rm (or rp) words at one end of a padded row over a thousand bytes long,
// so each row end costs a whole sector read and a whole sector written,
// scattered a row apart (remote_dma.remote_axis_sector_bytes; the sector
// floor, which the card serves well below its streaming rate, as
// self_fill.cu's x fill meets it).
//
// Design: row_moves.cuh, over a work list of the phase's two slab boxes
// (remote_dma.remote_axis_work). In the x phase the hi slab sent forward and
// the lo slab of the forward neighbour sent back are one paired segment, the
// two hand-offs of each row end on adjacent lanes, so one warp instruction
// reads and one writes both sectors of a boundary row: b's hi end and its
// forward neighbour's lo end. The y and z phases move whole padded rows as
// 16-byte vectors where the layout is on the 16-byte grid, one word at a
// time elsewhere. Stores go straight into the destination block's halo
// through its pointer (the reference's zero-copy ColoQuantityKernel /
// same-GPU PeerAccessSender write): no landing buffer and no unpack.
//
// The wire_dtype form (make_remote_axis_kernel's narrow VMEM staging,
// :101-146): with a wire code every slab word that leaves its position is
// rounded through the wire in registers between its load and its store
// (wire_round.cuh), so the halo receives the narrowed-and-widened word in the
// same one launch. With one block a position every slab of a ring phase
// leaves; over the blocks of an oversubscribed mesh the pointer rows of a
// sender whose neighbour shares its position are marked local
// (row_moves.cuh), and those shifts stay bit copies in the same launch, as
// the TPU carrier moves them locally. An axis with one position is not this
// kernel's: it is a self-wrap fill and never narrows.
//
// Ordering: within one phase every read is of a compute-region row along
// the axis and every write of a halo row along it; these are disjoint (the
// block is at least the radius wide). Phase y reads the x halos that phase x
// wrote, so the phases must run in order: on one card they are launches on
// one stream. Positions on distinct GPUs will also need each phase to wait
// on its ring neighbours' previous phase (an event per neighbour), which is
// the TPU kernel's barrier.

#include "row_moves.cuh"

// ptrs: device table of (sender block, neighbour block) pointer rows, m rows
// per group of the work list; segs: device table of nseg work-list rows
// (row_moves.cuh), their tasks ending at `tasks`; elem_size: 4 or 8; wire:
// the wire code (wire_round.cuh; 0 copies bits) and fmt its format's
// parameters (halo_fill.wire_params), applied to the segments flagged narrow
// on the instances not marked local; sz / sy: the padded block's plane and row strides in
// words. Launches on the current device, where every block lies.
extern "C" int remote_axis_launch(const void* ptrs, int m, const void* segs, int nseg,
                                  long long tasks, int elem_size, int wire, const double* fmt,
                                  long long sz, long long sy, void* stream) {
  return row_moves::launch(ptrs, m, segs, nseg, tasks, elem_size, wire, fmt, sz, sy, stream);
}

// The row-move body's instantiation for elem_size-byte words and the wire code
// (the same in fused_exchange.cu) on the current device: r[0] = registers,
// r[1] = local (spill) bytes per thread.
extern "C" int remote_axis_info(int elem_size, int wire, int* r) {
  return row_moves::info(elem_size, wire, r);
}
