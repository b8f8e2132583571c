// The byte-tile kernel: k <= 32 turns of any B/S rule per launch on a uint8
// {0, 255} board of any size, cut into 2-D tiles.
//
// Replaces the JAX package's Pallas kernel K6,
// gol_distributed_final_tpu/ops/fused.py:342 (byte_tiled_pallas_call, body
// _fused_byte_tiled_kernel at :325). That kernel runs full-width row blocks
// with 32-row halo strips, the uint8 Mosaic sublane tile; neither the strip
// depth nor the full width is part of the contract here.
//
// Design. Block (bx, by) owns the output tile of kTileR x kTileC cells at
// (by * kTileR, bx * kTileC). It loads that tile plus a k-cell halo on every
// side into shared memory as 0/1 bytes, the torus coming from indices taken
// modulo the board, so a board smaller than the window (64 x 128 at k = 32:
// a 96 x 192 window) wraps more than once and stays exact. It then runs k
// turns in shared memory, two window copies ping-ponged: after turn t only
// the cells at least t from the window's edge are valid, so turn t computes
// just that shrinking region, and after k turns the tile is exact and is
// written out as {0, 255}. Blocks run in no order, so the output goes to a
// second board; the wrapper ping-pongs (ops/byte_tiled.py), as csrc/tiled.cu
// does for the bitboard. No width limit comes from shared memory: a window
// is at most (32 + 64) x (128 + 64) bytes, two copies 36,864 B, under the
// 48 KB a block has without opting in.
//
// k is a run-time argument (1..32): the turn loop, the window extents and
// the per-unit division read it at run time, and the cells' inner loop
// (byte_step.cuh) has no division, so one instantiation serves every k.
//
// What bounds it. Each launch reads and writes the board once, 2 * H * W
// bytes. The function's cheapest form packs the board once, steps the
// bitboard at 12 int32 instructions per 32 cells per turn for Conway and
// unpacks it once (ops/bitpack.py::byte_ops_per_cell): at k = 8 that is 5
// instructions per cell, so device memory binds, not the integer rate. The
// kernel spends far more: 5 instructions per cell per turn of byte
// arithmetic, the halo ring it steps (at k = 8 a 32 x 128 tile computes
// ~1.29x the interior's cell-turns), the loads and stores around the
// arithmetic, and one barrier per turn.
#include <cuda_runtime.h>

#include <cstdint>

#include "byte_step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTurns = 32;
constexpr int kTileR = 32;   // output tile rows, in cells (ops/byte_tiled.py::TILE)
constexpr int kTileC = 128;  // output tile cols, in cells
constexpr int kMaxGridY = 65535;  // gridDim.y limit: tile rows of one launch

__device__ __forceinline__ int wrap(int i, int n) {
    const int m = i % n;
    return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(kThreads)
byte_tiled_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int rows,
                  int cols, int k, ByteRule rule) {
    extern __shared__ uint8_t smem[];
    const int er = kTileR + 2 * k;  // window rows
    const int ec = kTileC + 2 * k;  // window cols
    uint8_t* cur = smem;
    uint8_t* nxt = smem + er * ec;
    const int r0 = blockIdx.y * kTileR;
    const int c0 = blockIdx.x * kTileC;

    for (int i = threadIdx.x; i < er * ec; i += kThreads) {
        const int wr = i / ec;
        const int wc = i - wr * ec;
        const size_t gr = wrap(r0 - k + wr, rows);
        const size_t gc = wrap(c0 - k + wc, cols);
        cur[i] = in[gr * cols + gc] != 0;
    }
    __syncthreads();

    for (int t = 1; t <= k; ++t) {
        byte_turn<false>(cur, nxt, ec, er, ec, t, er - t, t, ec - t, rule);
        __syncthreads();
        uint8_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    for (int i = threadIdx.x; i < kTileR * kTileC; i += kThreads) {
        const int tr = i / kTileC;
        const int tc = i - tr * kTileC;
        const int gr = r0 + tr;
        const int gc = c0 + tc;
        if (gr < rows && gc < cols) {
            out[static_cast<size_t>(gr) * cols + gc] = cur[(k + tr) * ec + k + tc] ? 255 : 0;
        }
    }
}

}  // namespace

extern "C" {

// k turns (1..32) of `in` (uint8[rows, cols]) into `out`, which must not
// alias `in`. Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for a k outside 1..32, an empty board, or more tile
// rows than one launch's grid holds.
int gol_byte_tiled_step(const void* in, void* out, int rows, int cols, int k,
                        unsigned birth_mask, unsigned survive_mask, void* stream) {
    const int grid_y = (rows + kTileR - 1) / kTileR;
    if (k < 1 || k > kMaxTurns || rows < 1 || cols < 1 || grid_y > kMaxGridY) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const ByteRule rule{birth_mask, survive_mask << 1};
    const dim3 grid((cols + kTileC - 1) / kTileC, grid_y);
    const size_t smem = 2 * static_cast<size_t>(kTileR + 2 * k) * (kTileC + 2 * k);
    byte_tiled_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), rows, cols, k, rule);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
