// The byte-tile kernel: k <= 32 turns of any B/S rule per launch on a uint8
// {0, 255} board of any size, cut into 2-D tiles that step as bitboards in
// shared memory.
//
// Replaces the JAX package's Pallas kernel K6,
// gol_distributed_final_tpu/ops/fused.py:342 (byte_tiled_pallas_call, body
// _fused_byte_tiled_kernel at :325). That kernel runs full-width row blocks
// with 32-row halo strips, the uint8 Mosaic sublane tile; neither the strip
// depth nor the full width is part of the contract here.
//
// What bounds it. Each launch reads and writes the board once, 2 * H * W
// bytes. The function's cheapest form packs the board once, steps the
// bitboard at 12 int32 instructions per 32 cells per turn for Conway and
// unpacks it once (ops/bitpack.py::byte_ops_per_cell): at k = 8 that is 5
// instructions per cell, so device memory binds, not the integer rate. So
// the kernel keeps bytes at the device-memory boundary only.
//
// Design. Block (bx, by) owns the output tile of kRows x (32 * kWords) cells
// at (by * kRows, bx * 32 * kWords). Its window is the tile, k lines above
// and below, and one word (32 cells) left and right:
//
// - Gather and pack. One thread takes one word of the window: it wraps the
//   word's row and first column modulo the board once, loads the 32 bytes
//   as two 16-byte loads where the row is 16-byte aligned and the word does
//   not cross the torus seam or the board's ragged edge (byte by byte there,
//   wrapping by a compare), and packs them (byte_pack.cuh). The torus is
//   resolved in cells, before packing, so no board size need divide by 32,
//   and a board smaller than the window wraps more than once and stays exact.
// - Step k turns on the packed window with bit_step.cuh's walk, two copies
//   ping-ponged, one barrier a turn. Across the lines the halo shrinks:
//   turn t steps the lines at least t from the window's edge. Along the
//   packed axis the halo is one word: it is stepped every turn with itself
//   as its missing outer neighbour, which spoils one more of its outer bits
//   a turn. After 31 turns only the bit next to the tile is still right, and
//   turn 32 reads just that bit, so one word covers every k <= 32.
// - Unpack the tile with 16-byte stores of {0, 255} (byte by byte at the
//   ragged edge).
//
// Blocks run in no order, so the output goes to a second board; the wrapper
// ping-pongs (ops/byte_tiled.py). k is a run-time argument; the tile and the
// rule are template parameters (the four named rules compiled in, any other
// as a DynamicRule).
//
// Two tiles, chosen by a sweep on an H100 (PERF.md). A 4096^2 board wants
// large tiles: the window's extra words are read again from L2 and stepped,
// 1.25x the tile's along the packed axis at 8 words and 1.25x across the
// lines at 64 rows and k = 8. A 512^2 board wants many blocks: at 64 x 256
// cells it has 16 for 132 SMs. So a board whose wide tiles number under
// the SMs takes the small tile, 256 blocks of 128 threads at 512^2
// (ops/byte_tiled.py::tile_for chooses, and the entry point runs the tile
// it is handed).
#include <cuda_runtime.h>

#include <cstdint>

#include "bit_step.cuh"
#include "byte_pack.cuh"

namespace {

constexpr int kMaxTurns = 32;
constexpr int kMaxGridY = 65535;  // gridDim.y limit: tile rows of one launch
constexpr int kTileR = 64;        // the wide tile, in cells (ops/byte_tiled.py::TILE)
constexpr int kTileC = 256;
constexpr int kSmallTileR = 16;   // the small tile (ops/byte_tiled.py::SMALL_TILE)
constexpr int kSmallTileC = 64;

template <int ROWS, int COLS, int THREADS>
struct Tile {
    static_assert(COLS % 32 == 0, "a tile is whole words wide");
    static constexpr int kRows = ROWS;
    static constexpr int kCols = COLS;
    static constexpr int kWords = COLS / 32;
    static constexpr int kP = kWords + 2;  // the window's words per line
    static constexpr int kThreads = THREADS;
};
using WideTile = Tile<kTileR, kTileC, 256>;
using SmallTile = Tile<kSmallTileR, kSmallTileC, 128>;

// i modulo n for any int i and n > 0: the fast path takes the indices that
// are already on the board
__device__ __forceinline__ int wrap(int i, int n) {
    if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
    const int m = i % n;
    return m < 0 ? m + n : m;
}

// `wide`: rows and both boards are 16-byte aligned. `run_len`, `runs`: each
// thread below kP * runs steps a run of run_len lines at one packed index.
template <class T, class Rule>
__global__ void __launch_bounds__(T::kThreads)
byte_tiled_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int rows,
                  int cols, int k, int run_len, int runs, int wide, Rule rule) {
    extern __shared__ uint32_t smem[];
    const int lines = T::kRows + 2 * k;
    uint32_t* cur = smem;
    uint32_t* nxt = smem + lines * T::kP;
    const int r0 = blockIdx.y * T::kRows;
    const int c0 = blockIdx.x * T::kCols;

    for (int e = threadIdx.x; e < lines * T::kP; e += T::kThreads) {
        const int line = e / T::kP;
        const int w = e - line * T::kP;
        const uint8_t* row = in + static_cast<size_t>(wrap(r0 - k + line, rows)) * cols;
        const int gc = wrap(c0 + 32 * (w - 1), cols);
        cur[e] = (wide && gc + 32 <= cols) ? gol_pack32_wide(row + gc)
                                           : gol_pack32_wrapped(row, gc, cols);
    }

    // this thread's run: lines [j0, j0 + run_len) at packed index i;
    // neighbouring lanes take neighbouring words of a line
    const int tid = threadIdx.x;
    const int r = tid / T::kP;
    const int i = tid - r * T::kP;
    const int j0 = r * run_len;
    const bool active = r < runs;
    const int m = i == 0 ? 0 : i - 1;             // the halo words' outer
    const int p = i + 1 == T::kP ? i : i + 1;     // neighbour is the word itself
    __syncthreads();

    for (int t = 1; t <= k; ++t) {
        // the cone: turn t steps lines t .. lines - t - 1
        const int js = max(j0, t);
        const int je = min(j0 + run_len, lines - t);
        if (active && js < je) {
            gol_walk(cur + m, cur + i, cur + p, nxt + i, (js - 1) * T::kP, js * T::kP,
                     T::kP, je - js, je * T::kP, rule);
        }
        __syncthreads();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    for (int e = threadIdx.x; e < T::kRows * T::kWords; e += T::kThreads) {
        const int tr = e / T::kWords;
        const int tw = e - tr * T::kWords;
        const int gr = r0 + tr;
        const int gc = c0 + 32 * tw;
        if (gr >= rows || gc >= cols) continue;
        const uint32_t word = cur[(k + tr) * T::kP + 1 + tw];
        uint8_t* dst = out + static_cast<size_t>(gr) * cols + gc;
        if (wide && gc + 32 <= cols) {
            gol_unpack32_wide(word, dst);
        } else {
            gol_unpack_bytes(word, dst, min(32, cols - gc));
        }
    }
}

template <class T, class Rule>
int launch(const void* in, void* out, int rows, int cols, int k, Rule rule,
           cudaStream_t stream) {
    const int grid_y = (rows + T::kRows - 1) / T::kRows;
    if (grid_y > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
    const int lines = T::kRows + 2 * k;
    // the shortest odd runs that give every thread at most one (odd: lanes
    // whose runs start run_len lines apart then spread over the banks)
    const int runs_max = T::kThreads / T::kP;
    const int run_len = ((lines + runs_max - 1) / runs_max) | 1;
    const int runs = (lines + run_len - 1) / run_len;
    const int wide = cols % 16 == 0 && gol_wide_ok(in, out);
    const dim3 grid((cols + T::kCols - 1) / T::kCols, grid_y);
    const size_t smem = 2 * static_cast<size_t>(lines) * T::kP * sizeof(uint32_t);
    byte_tiled_kernel<T, Rule><<<grid, T::kThreads, smem, stream>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), rows, cols, k, run_len,
        runs, wide, rule);
    return static_cast<int>(cudaGetLastError());
}

// The largest window, 2 * (kTileR + 2 * kMaxTurns) * (kTileC / 32 + 2) words,
// is 10,240 B: under the 48 KB a block has without opting in.
static_assert(2 * (kTileR + 2 * kMaxTurns) * (kTileC / 32 + 2) * 4 <= 48 * 1024, "window");

}  // namespace

extern "C" {

// k turns (1..32) of `in` (uint8[rows, cols]) into `out`, which must not
// alias `in`, on the tile given: 1 the wide one, 2 the small one. Returns
// cudaGetLastError() after the launch (0 on success); cudaErrorInvalidValue
// for a k outside 1..32, an empty board, an unknown tile, or more tile rows
// than one launch's grid holds.
int gol_byte_tiled_step_tile(const void* in, void* out, int rows, int cols, int k,
                             unsigned birth_mask, unsigned survive_mask, int tile,
                             void* stream) {
    if (k < 1 || k > kMaxTurns || rows < 1 || cols < 1 || tile < 1 || tile > 2) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return gol_with_bs_rule(birth_mask, survive_mask, [&](auto rule) {
        if (tile == 1) return launch<WideTile>(in, out, rows, cols, k, rule, s);
        return launch<SmallTile>(in, out, rows, cols, k, rule, s);
    });
}

}  // extern "C"
