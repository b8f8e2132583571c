// One turn of a life-like rule on a byte-per-cell board in shared memory,
// shared by the whole-board byte kernel (byte_board.cu, K5) and the byte
// tiles (byte_tiled.cu, K6). The JAX package's counterpart is byte_turn_fn
// (gol_distributed_final_tpu/ops/pallas_stencil.py:91).
//
// Cells hold 0 or 1 in shared memory: the kernels turn any nonzero byte into
// 1 when they load a board and write 255 for 1 when they store it. The rule
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

// Rows [r0, r1) of column c of `nxt` from `cur` (row pitch `pitch`); cl and
// cr are the columns on its left and right. With WRAP the rows wrap modulo
// `rows` (the buffer is the whole torus); without it the caller keeps rows
// r0 - 1 and r1 inside the buffer.
template <bool WRAP>
__device__ __forceinline__ void byte_walk(const uint8_t* __restrict__ cur,
                                          uint8_t* __restrict__ nxt, int pitch, int rows,
                                          int c, int cl, int cr, int r0, int r1,
                                          ByteRule rule) {
    int ru = r0 - 1;
    if (WRAP && ru < 0) ru += rows;
    const uint8_t* up = cur + ru * pitch;
    const uint8_t* md = cur + r0 * pitch;
    int above = up[cl] + up[c] + up[cr];
    int here = md[cl] + md[c] + md[cr];
    int self = md[c];
    for (int r = r0; r < r1; ++r) {
        int rd = r + 1;
        if (WRAP && rd == rows) rd = 0;
        const uint8_t* dn = cur + rd * pitch;
        const int below_c = dn[c];
        const int below = dn[cl] + below_c + dn[cr];
        const int t = above + here + below;
        nxt[r * pitch + c] = ((self ? rule.live : rule.dead) >> t) & 1u;
        above = here;
        here = below;
        self = below_c;
    }
}

// One turn of the region rows [r_lo, r_hi) x cols [c_lo, c_hi) by all the
// threads of the block. With WRAP the region is the whole `rows` x `cols`
// torus and the neighbours of its edges wrap; without it the region keeps
// one cell inside the buffer on every side.
template <bool WRAP>
__device__ __forceinline__ void byte_turn(const uint8_t* __restrict__ cur,
                                          uint8_t* __restrict__ nxt, int pitch, int rows,
                                          int cols, int r_lo, int r_hi, int c_lo, int c_hi,
                                          ByteRule rule) {
    const int width = c_hi - c_lo;
    const int units = width * ((r_hi - r_lo + kByteChunkRows - 1) / kByteChunkRows);
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
        const int q = u / width;
        const int c = c_lo + (u - q * width);
        const int r0 = r_lo + q * kByteChunkRows;
        const int r1 = min(r0 + kByteChunkRows, r_hi);
        int cl = c - 1;
        int cr = c + 1;
        if (WRAP) {
            if (cl < 0) cl = cols - 1;
            if (cr == cols) cr = 0;
        }
        byte_walk<WRAP>(cur, nxt, pitch, rows, c, cl, cr, r0, r1, rule);
    }
}
