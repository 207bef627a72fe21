// Per-direction halo messages of a uniform partition's blocks, read by
// mesh_chunk.cuh.
//
// A box is one direction's exact-extent message: it copies a block's compute
// cells (src) into the halo cells on the opposite side (dst) of the receiving
// block, which on a single, all-self-wrap block is the block itself. Boxes of
// distinct directions write disjoint halo cells and read only compute cells,
// so they may run in any order, concurrently.

#pragma once

#include <cuda_runtime.h>

struct DirBoxes {
  int n;
  int box[26][9];       // src (z, y, x), dst (z, y, x), extent (z, y, x)
  long long start[27];  // cells before box b; start[n] is the total
};

// Build the table from n rows of 9 ints; false if it does not fit.
inline bool make_dir_boxes(const int* rows, int n, DirBoxes* out) {
  if (n < 0 || n > 26) return false;
  out->n = n;
  out->start[0] = 0;
  for (int b = 0; b < n; ++b) {
    for (int j = 0; j < 9; ++j) out->box[b][j] = rows[9 * b + j];
    const long long cells = (long long)rows[9 * b + 6] * rows[9 * b + 7] * rows[9 * b + 8];
    if (cells < 0 || cells >= (1LL << 31)) return false;
    out->start[b + 1] = out->start[b] + cells;
  }
  return true;
}
