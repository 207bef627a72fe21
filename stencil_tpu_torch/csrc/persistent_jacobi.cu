// One k-step Jacobi chunk of every fp32 block position of one device in one
// launch: the deep (radius k) halo messages of every direction, then the k
// substeps of every position with every substep of a tile kept on chip.
//
// Replaces: stencil_tpu/ops/persistent_stencil.py:199
// make_persistent_jacobi_kernel, in its all-self-wrap (one device) form and
// its wire-crossing form (a mesh of block positions: barrier with the ring
// neighbours, one deep exchange, k substeps streaming planes through a mod-3
// VMEM ring). Python wrappers and plain PyTorch versions:
// stencil_tpu_torch/ops/persistent_stencil.py (persistent_jacobi /
// persistent_jacobi_plain for one block, persistent_jacobi_mesh /
// persistent_jacobi_mesh_plain for a mesh, uniform or uneven;
// persistent_jacobi_across / persistent_jacobi_receivers_plain for a mesh
// spread over processes). A single block is the one-position case: its
// messages all wrap onto itself. On an uneven partition the launch takes
// each position's own extent from a table and runs no messages: the
// caller's deep exchange has filled the halos.
//
// The result contract (mesh_chunk.cuh, mesh_onchip_chunk): each position's a
// holds curr, b nxt. The messages copy compute cells into the destination
// position's halos (26 exact-extent boxes at the block's radius, which is at
// least k). The k substeps run in ceil(k / 6) on-chip passes of balanced
// depth; a pass reads one buffer over the region grown by the depth still to
// run and writes only the other, over the region grown by the depth left
// after it. So the result is in b for every chunk of k <= 6 (and, beyond, when
// the passes are odd in number: ops/persistent_stencil.py result_in_nxt), and
// only its compute region is written; sel must arrive halo-filled. The TPU
// kernel ping-pongs every substep through both buffers (its result in nxt
// for odd k); it computes the same field. The redundant grown-region cells
// reproduce the neighbour's own values bit for bit (one operand order,
// -fmad=false), so a chunk equals k plain steps.
//
// What bounds it on an H100: bytes. The least a chunk must move is one read
// of curr and sel and one write of the result over each halo-grown block,
// 12 * (n + 2k)^3 bytes per n^3 block (0.504 ms at 512^3, k = 4). A pass
// moves one read of its source and sel over its grown region and one write
// of the region it keeps, plus the messages (chunk_design_bytes); tiles
// re-read their neighbours' ghost zones, mostly from L2. The on-chip stages
// cost shared-memory traffic (four neighbour loads and a store per cell and
// substep) and a barrier per plane, as in the multistep kernel
// (jacobi_multistep.cu), whose design this pass reuses.
//
// Design: a cooperative launch (cudaLaunchCooperativeKernel) of blocks of
// two cells of the grown plane a thread (800 threads at k = 4), as many as
// can be resident at once with the pass's dynamic shared memory (occupancy x
// SMs: one per SM), each block walking
// the messages' cells, then each pass's tiles (32 x 32 outputs at the full
// depth, z chunks, every position), with cooperative_groups::this_grid()
// .sync() after the messages and between passes. One launch per (device,
// chunk) covers every position, so no kernel ever waits for another launch.
// The kernel is instantiated for pass depths K = 2..6, with and without the
// K - 1 body of a chunk of several passes, and each once more for the uneven
// form (its own walk, so the uniform instantiations keep their code); a chunk
// runs the instantiation of its deepest pass.
//
// Across processes of one card the same instantiations run over one
// process's positions: the position table holds its own rows, swept, and
// after them the other processes' positions whose cells its deep messages
// pull through CUDA IPC. A chunk of one pass is one launch after one
// interprocess handshake; a chunk of several passes is two, the second
// (passes 1 and on) after a second handshake, since pass 1 overwrites the
// compute cells of a that other processes pull in their first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_chunk.cuh"

namespace {

using namespace jacobi;

template <int K, bool MULTI, bool UNEVEN>
__global__ void __launch_bounds__(onchip_threads(K), 1)
persistent_jacobi_kernel(const __grid_constant__ MeshChunk c) {
  mesh_onchip_chunk<K, MULTI, UNEVEN>(c);
}

// the depth of the instantiation a depth-k chunk runs: its deepest pass
int depth_of(int k) { return pass_depth(k, 0); }

template <int K, bool UNEVEN = false>
cudaError_t launch(const MeshChunk& c, int dev, void* stream) {
  const size_t smem = (size_t)onchip_smem_bytes(K);
  const dim3 block(onchip_threads(K));
  return chunk_passes(c.k) > 1
             ? mesh_chunk_launch(persistent_jacobi_kernel<K, true, UNEVEN>, c, dev, stream, block,
                                 smem)
             : mesh_chunk_launch(persistent_jacobi_kernel<K, false, UNEVEN>, c, dev, stream, block,
                                 smem);
}

template <int K>
cudaError_t occupancy(int k, int* blocks) {
  const size_t smem = (size_t)onchip_smem_bytes(K);
  return chunk_passes(k) > 1
             ? mesh_chunk_occupancy(persistent_jacobi_kernel<K, true, false>, onchip_threads(K),
                                    smem, blocks)
             : mesh_chunk_occupancy(persistent_jacobi_kernel<K, false, false>, onchip_threads(K),
                                    smem, blocks);
}

}  // namespace

// pos: device table of npos rows (curr, nxt, sel pointers), the first nsweep
// swept; msg: device table of nboxes * m rows (source row, destination row,
// box index), m rows per box in box order, m = nsweep; boxes: nboxes rows of
// 9 ints (src z y x, dst z y x, extent z y x), the deep messages at the
// block's radius; every block a contiguous (pz, py, px) array with plane
// stride sz and row stride sy, compute region at (zo, yo, xo) of nz x ny x nx
// cells; k >= 2; the launch runs passes [pass0, pass1) of the chunk
// (persistent_jacobi_passes), the messages with pass 0; dev: the device of
// every block.
//
// In one process every row is swept (nsweep = npos) and a launch runs every
// pass. Across the processes of one card (a mesh spread over them,
// persistent_stencil.persistent_jacobi_across) a process launches over its
// own positions: its rows first, swept, then the other processes' positions
// its messages come from, mapped through CUDA IPC, of which only a is read;
// its message rows are those into its own positions. A chunk of several
// passes is then two launches, the caller ordering the second (passes 1 and
// on) behind the other processes' reads of a (parallel/ipc.PhaseOrder).
//
// ext: null on a uniform partition; else the uneven form (a mesh of an uneven
// partition, the TPU kernel's refusal, stencil_tpu/ops/jacobi.py:560-616, where
// the JAX package runs one deep exchange and its XLA chunk body): a device
// table of nsweep rows (nz, ny, nx), int64, each row's own compute extent,
// nz, ny, nx the largest (the base block); no messages (msg null, m = 0),
// since the caller's deep exchange (B6's uneven ring, at the chunk's radius)
// has filled every halo; then the same passes, each position's tiles at its
// own extent. The result contract is the uniform form's.
extern "C" int persistent_jacobi_launch(const void* pos, int npos, int nsweep, const void* msg,
                                        int m, const int* boxes, int nboxes, const void* ext,
                                        long long sz, long long sy, int zo, int yo, int xo,
                                        int nz, int ny, int nx, int k, int pass0, int pass1,
                                        int dev, void* stream) {
  MeshChunk c;
  const bool uneven = ext != nullptr;
  if (k < 2 || sz >= (1LL << 31) || nsweep < 1 || nsweep > npos || pass0 < 0 ||
      pass1 > chunk_passes(k) || pass0 >= pass1 || (uneven && (m != 0 || npos != nsweep)) ||
      (!uneven && m != nsweep) ||
      !make_mesh_chunk(pos, npos, msg, m, boxes, nboxes, sz, sy, zo, yo, xo, nz, ny, nx, k, &c,
                       ext))
    return (int)cudaErrorInvalidValue;
  c.nsweep = nsweep;
  c.pass0 = pass0;
  c.pass1 = pass1;
  switch (depth_of(k)) {
    case 2: return (int)(uneven ? launch<2, true>(c, dev, stream) : launch<2>(c, dev, stream));
    case 3: return (int)(uneven ? launch<3, true>(c, dev, stream) : launch<3>(c, dev, stream));
    case 4: return (int)(uneven ? launch<4, true>(c, dev, stream) : launch<4>(c, dev, stream));
    case 5: return (int)(uneven ? launch<5, true>(c, dev, stream) : launch<5>(c, dev, stream));
    case 6: return (int)(uneven ? launch<6, true>(c, dev, stream) : launch<6>(c, dev, stream));
    default: return (int)cudaErrorInvalidValue;
  }
}

// The on-chip passes of a depth-k chunk: their number, and their depths in
// depths[0 .. min(number, cap) - 1].
extern "C" int persistent_jacobi_passes(int k, int* depths, int cap) {
  if (k < 1) return 0;
  const int n = chunk_passes(k);
  for (int p = 0; p < n && p < cap; ++p) depths[p] = pass_depth(k, p);
  return n;
}

// Dynamic shared memory of the instantiation a depth-k chunk runs.
extern "C" long long persistent_jacobi_smem_bytes(int k) {
  return k < 2 ? 0 : onchip_smem_bytes(depth_of(k));
}

// Resident blocks per SM of the instantiation a depth-k chunk runs, on dev.
extern "C" int persistent_jacobi_blocks_per_sm(int k, int dev, int* blocks) {
  DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  switch (k < 2 ? 0 : depth_of(k)) {
    case 2: return (int)occupancy<2>(k, blocks);
    case 3: return (int)occupancy<3>(k, blocks);
    case 4: return (int)occupancy<4>(k, blocks);
    case 5: return (int)occupancy<5>(k, blocks);
    case 6: return (int)occupancy<6>(k, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Threads per block of the instantiation a depth-k chunk runs.
extern "C" int persistent_jacobi_threads(int k) {
  return k < 2 ? 0 : onchip_threads(depth_of(k));
}
