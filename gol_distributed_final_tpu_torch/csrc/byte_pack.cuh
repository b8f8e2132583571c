// Bytes at the device-memory boundary, bits on chip: what the two byte
// kernels (byte_board.cu, K5, and byte_tiled.cu, K6) share to turn a uint8
// board into bitboard words as they load it, and back into {0, 255} bytes as
// they store it. Between the two the turns run on packed words with
// bit_step.cuh's core.
//
// Alive is "byte != 0", not "byte & 1". Bit b of a word is the b-th of 32
// consecutive cells, as everywhere in ops/bitpack.py.
//
// Four bytes of a register become four bits with one per-byte compare and
// one multiply that gathers them (ops/bitpack.py::PACK_OPS_PER_CELL counts
// this form); four bits become four bytes with one multiply that spreads
// them, a mask and a multiply by 255. A thread moves 32 cells as two 16-byte
// loads or stores where the address allows it.
#pragma once

#include <cstdint>

// Bytes 0..3 of `bytes` -> bits 0..3. The compare leaves 1 in each nonzero
// byte (bits 0, 8, 16, 24); the multiplier moves them to bits 28..31, and no
// other partial product lands there or carries into them.
__device__ __forceinline__ uint32_t gol_pack4(uint32_t bytes) {
    return (__vsetne4(bytes, 0u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t gol_pack16(uint4 v) {
    return gol_pack4(v.x) | (gol_pack4(v.y) << 4) | (gol_pack4(v.z) << 8) |
           (gol_pack4(v.w) << 12);
}

// 32 cells at a 16-byte aligned address.
__device__ __forceinline__ uint32_t gol_pack32_wide(const uint8_t* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 lo = __ldg(q);
    const uint4 hi = __ldg(q + 1);
    return gol_pack16(lo) | (gol_pack16(hi) << 16);
}

// 32 cells of one row starting at column `c`, byte by byte, wrapping to
// column 0 whenever the row of `cols` cells ends (more than once where the
// row is shorter than 32 cells).
__device__ __forceinline__ uint32_t gol_pack32_wrapped(const uint8_t* row, int c, int cols) {
    uint32_t word = 0;
#pragma unroll 4
    for (int b = 0; b < 32; ++b) {
        word |= static_cast<uint32_t>(row[c] != 0) << b;
        if (++c == cols) c = 0;
    }
    return word;
}

// Bits 0..3 of `nibble` (nothing above them set) -> bytes 0..3 of 0 or 255.
__device__ __forceinline__ uint32_t gol_unpack4(uint32_t nibble) {
    return ((nibble * 0x00204081u) & 0x01010101u) * 255u;
}

__device__ __forceinline__ uint4 gol_unpack16(uint32_t bits) {
    return make_uint4(gol_unpack4(bits & 15u), gol_unpack4((bits >> 4) & 15u),
                      gol_unpack4((bits >> 8) & 15u), gol_unpack4((bits >> 12) & 15u));
}

// 32 cells to a 16-byte aligned address.
__device__ __forceinline__ void gol_unpack32_wide(uint32_t word, uint8_t* p) {
    uint4* q = reinterpret_cast<uint4*>(p);
    q[0] = gol_unpack16(word);
    q[1] = gol_unpack16(word >> 16);
}

// The first `count` <= 32 cells of `word`, byte by byte.
__device__ __forceinline__ void gol_unpack_bytes(uint32_t word, uint8_t* p, int count) {
    for (int b = 0; b < count; ++b) p[b] = (word >> b & 1u) ? 255 : 0;
}

// Whether both boards start on a 16-byte boundary (the wide paths also need
// a row length that keeps every row on one).
inline bool gol_wide_ok(const void* in, const void* out) {
    return ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
}
