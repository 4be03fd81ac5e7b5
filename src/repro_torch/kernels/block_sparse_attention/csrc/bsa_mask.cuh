// The liveness predicate of block-sparse attention, SHARED by the forward
// (K1, block_sparse_attention.cu) and both backward sweeps (K2a dq, K2b
// dk/dv, block_sparse_attention_bwd.cu).  The reference keeps its TPU
// kernels in lockstep the same way (`tile_active` / `tile_scores` in
// src/repro/kernels/block_sparse_attention/block_sparse_attention.py): a
// (q, k) pair computed in one direction and skipped in the other would give
// silently wrong gradients.
//
// An element (row r, column c) is live iff mask[r / block, c / block] > 0,
// c < Sk, r < Sq and, when causal, r >= c.  The mask block (128 or 512 on
// the main path) is the semantics; the 64 x 64 CUDA tile is free and is
// expanded over the mask blocks that cover it.
#pragma once

#include <stdint.h>

// A tile [r0, r_last] x [c0, c_last] (already clipped to Sq / Sk) does work
// iff one of the mask blocks covering it is live and, when causal, it
// reaches at or below the diagonal.
__device__ __forceinline__ bool bsa_tile_live(const int32_t* mb, int nkb,
                                              int block, int r0, int r_last,
                                              int c0, int c_last,
                                              int causal) {
  if (causal && c0 > r_last) return false;
  for (int qi = r0 / block; qi <= r_last / block; ++qi)
    for (int ki = c0 / block; ki <= c_last / block; ++ki)
      if (mb[qi * nkb + ki] > 0) return true;
  return false;
}

// The element predicate inside a live tile.  ``uniform``: the tile lies
// inside one mask block (block is a multiple of the tile), which the tile
// check has already found live, so no per-element lookup is needed.
__device__ __forceinline__ bool bsa_elem_live(const int32_t* mb, int nkb,
                                              int block, int row, int col,
                                              int Sq, int Sk, int causal,
                                              bool uniform) {
  bool keep = row < Sq && col < Sk && (!causal || row >= col);
  if (keep && !uniform) keep = mb[(row / block) * nkb + col / block] > 0;
  return keep;
}
