// One k-step Jacobi chunk of every fp32 block position of one device in one
// launch: the deep (radius k) halo messages of every direction, then k sweeps
// over shrinking grown regions of every position, ping-ponging between each
// position's two buffers.
//
// Replaces: stencil_tpu/ops/persistent_stencil.py
// make_persistent_jacobi_kernel, in its all-self-wrap (one device) form and
// its wire-crossing form (a mesh of block positions: barrier with the ring
// neighbours, one deep exchange, k substeps). Python wrappers and plain
// PyTorch versions: stencil_tpu_torch/ops/persistent_stencil.py
// (persistent_jacobi / persistent_jacobi_plain for one block,
// persistent_jacobi_mesh / persistent_jacobi_mesh_plain for a mesh). A single
// block is the one-position case: its messages all wrap onto itself.
//
// Semantics (mesh_chunk.cuh): each position's a holds curr, b holds nxt. The
// messages copy compute cells into the destination position's halos (26
// exact-extent boxes at the block's radius, which is at least k). Substep
// s = 0..k-1 reads buffer (s even ? a : b) over the region grown k - s cells
// past the compute region, and writes the other buffer over the region grown
// k - 1 - s cells. sel must arrive halo-filled. The chunk's result is in b
// when k is odd and in a when k is even. The redundant grown-region cells
// reproduce the neighbour's own values bit for bit (one operand order,
// -fmad=false), so a chunk equals k plain steps.
//
// What bounds it on an H100: bytes. The least a chunk must move is one read
// of curr and sel and one write of the result over each halo-grown block,
// 12 * (n + 2k)^3 bytes per n^3 block. This simple design moves more: each
// substep reads its source, reads sel and writes its destination over its
// grown region (about k times the floor), through L2 and device memory.
//
// Design: a cooperative launch (cudaLaunchCooperativeKernel), no more blocks
// than can be resident at once on the device (occupancy x SMs), each block
// walking the messages' cells and then each substep's tiles of every
// position, with cooperative_groups::this_grid().sync() after the messages
// and after each substep but the last. A tile is 32x8 columns of one z range
// of one position's grown region, marched in z by the sweep's column march
// (jacobi_column.cuh) with no wrapping: the grown region reads the filled
// halos. One launch per (device, chunk) covers every position, so no kernel
// ever waits for another launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_chunk.cuh"

namespace {

using namespace jacobi;

__global__ void __launch_bounds__(THREADS)
persistent_jacobi_kernel(const __grid_constant__ MeshChunk c) {
  mesh_chunk(c);
}

}  // namespace

// pos: device table of npos rows (curr, nxt, sel pointers); msg: device table
// of nboxes * m rows (source position, destination position, box index), m
// rows per box in box order; boxes: nboxes rows of 9 ints (src z y x, dst
// z y x, extent z y x), the deep messages at the block's radius; every block
// a contiguous (pz, py, px) array with plane stride sz and row stride sy,
// compute region at (zo, yo, xo) of nz x ny x nx cells; dev: the device of
// every block.
extern "C" int persistent_jacobi_launch(const void* pos, int npos, const void* msg, int m,
                                        const int* boxes, int nboxes, long long sz,
                                        long long sy, int zo, int yo, int xo, int nz, int ny,
                                        int nx, int k, int dev, void* stream) {
  MeshChunk c;
  if (!make_mesh_chunk(pos, npos, msg, m, boxes, nboxes, sz, sy, zo, yo, xo, nz, ny, nx, k,
                       &c))
    return (int)cudaErrorInvalidValue;
  return (int)mesh_chunk_launch(persistent_jacobi_kernel, c, dev, stream);
}
