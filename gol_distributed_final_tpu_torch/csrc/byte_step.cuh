// One turn of a life-like rule on a byte-per-cell torus in shared memory:
// the byte form of the whole-board byte kernel (byte_board.cu, K5), for
// boards with no axis that packs into whole words. The JAX package's
// counterpart is byte_turn_fn
// (gol_distributed_final_tpu/ops/pallas_stencil.py:91).
//
// Cells hold 0 or 1 in shared memory: the kernel turns any nonzero byte into
// 1 when it loads a board and writes 255 for 1 when it stores it. The rule
// is read on T, the 3x3 sum INCLUDING the cell, as ops/bitpack.py's bit_step
// reads it: a dead cell is born iff bit T of the birth mask is set, a live
// cell survives iff bit T of (survive mask << 1) is. One shift and one AND
// look the rule up, and nothing subtracts the cell.
//
// Work is cut into units of one column by kByteChunkRows rows. A thread
// walks its unit down the column and keeps the horizontal three-cell sums of
// the row above and of its own row in registers, so a cell costs three
// shared-memory loads (the row below) and two adds, and no division.
// Neighbouring threads take neighbouring columns, so a warp loads 32
// consecutive bytes.
#pragma once

#include <cstdint>

constexpr int kByteChunkRows = 8;

struct ByteRule {
    unsigned dead;  // bit T set: a dead cell whose 3x3 sum is T is born
    unsigned live;  // bit T set: a live cell whose 3x3 sum is T survives
};

// Rows [r0, r1) of column c of `nxt` from `cur`, both the whole `rows` x
// `cols` torus; cl and cr are the columns on its left and right.
__device__ __forceinline__ void byte_walk(const uint8_t* __restrict__ cur,
                                          uint8_t* __restrict__ nxt, int rows, int cols,
                                          int c, int cl, int cr, int r0, int r1,
                                          ByteRule rule) {
    const uint8_t* up = cur + (r0 == 0 ? rows - 1 : r0 - 1) * cols;
    const uint8_t* md = cur + r0 * cols;
    int above = up[cl] + up[c] + up[cr];
    int here = md[cl] + md[c] + md[cr];
    int self = md[c];
    for (int r = r0; r < r1; ++r) {
        const uint8_t* dn = cur + (r + 1 == rows ? 0 : r + 1) * cols;
        const int below_c = dn[c];
        const int below = dn[cl] + below_c + dn[cr];
        const int t = above + here + below;
        nxt[r * cols + c] = ((self ? rule.live : rule.dead) >> t) & 1u;
        above = here;
        here = below;
        self = below_c;
    }
}

// One turn of the whole torus by all the threads of the block.
__device__ __forceinline__ void byte_turn(const uint8_t* __restrict__ cur,
                                          uint8_t* __restrict__ nxt, int rows, int cols,
                                          ByteRule rule) {
    const int units = cols * ((rows + kByteChunkRows - 1) / kByteChunkRows);
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
        const int q = u / cols;
        const int c = u - q * cols;
        const int r0 = q * kByteChunkRows;
        byte_walk(cur, nxt, rows, cols, c, c == 0 ? cols - 1 : c - 1,
                  c + 1 == cols ? 0 : c + 1, r0, min(r0 + kByteChunkRows, rows), rule);
    }
}
