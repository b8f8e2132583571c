// The activity-sparse step: blocks of h <= 8 turns of a life-like rule
// without birth on 0 neighbours, computed only on the active tiles of a
// packed int32 board [rows, cols] (word axis 0: bit j of word (r, c) is
// cell (32 r + j, c)), on the torus.
//
// Replaces the XLA program of the JAX package's activity-sparse plane,
// gol_distributed_final_tpu/ops/sparse.py:189 (_sparse_program): its
// lax.while_loop of gather, h bit_steps on the gathered batch, scatter and
// a dilated change grid. There it is one dispatch per step_n piece; here
// it is one C call that enqueues every launch of the dispatch on the
// current stream and never waits: the host reads what it needs once, at
// the end (ops/sparse_tiles.py).
//
// The loop's state on the card:
// - the board and the activity grid uint8[gr, gc] (gr = rows / tr, gc =
//   cols / tc), both written in place: the wrapper hands over copies;
// - counts int32[n_blocks + 1], zeroed: counts[k] is the number of active
//   tiles that block k starts from (the reference's `cnt`);
// - the list of active tiles (at most `capacity` of them, in no order) and
//   a change grid uint8[gr, gc], zeroed.
// Block k runs only while 1 <= counts[k] <= capacity. That is the
// reference's cond: a count past the capacity is its overflow, which
// commits nothing; a count of 0 is an empty grid. A block that does not run
// writes no count, so every later block sees 0 and does not run either:
// the dispatch stops where the while_loop stops, and the host finds where
// from the counts alone.
//
// Per block, three launches:
// 1. step: one CTA per slot of the list, the grid set to `capacity`. It
//    loads its tile's window of (tr + 2) x (tc + 2h) words into shared
//    memory (one word row above and below, h columns each side, indices
//    modulo the board), steps h turns with bit_step.cuh's sliding-window
//    walk (the halo scheme of tiled.cu for word axis 0: the halo word rows
//    are stepped with their outer neighbour taken as themselves, which
//    spoils one outer bit a turn and never reaches the tile while h < 32;
//    across the columns the cone shrinks one word a turn), ORs each turn's
//    change of the tile into a flag (an oscillator whose period divides h
//    stays active, ops/sparse.py:237-248 of the reference), writes the new
//    tile to a scratch of capacity x tr x tc words and the flag to the
//    change grid. It writes nothing into the board: other CTAs still read
//    their halos from it.
// 2. scatter: each changed tile's scratch back into the board.
// 3. dilate: a tile is active when any of its 9 neighbours on the torus of
//    tiles changed; the grid is written and the active tiles are appended
//    to the list and counted into counts[k + 1].
// The change grid holds True only for tiles of the last block's list: a
// tile that changed is active in the next block, whose step writes its
// flag again, so the grid never has to be cleared between blocks.
//
// What bounds it. Per block the card reads each active tile's window and
// writes back the tiles that changed, and does ops/bitpack.py::
// ops_per_word int32 instructions per word per turn over the active tiles'
// words; at the frontiers the main path gives it (tens to hundreds of
// tiles of 8 x 128 words) either is well under the three launches' own
// cost, a few microseconds each. So a block costs about its launches, and
// the design keeps them to three with no wait on the host.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "bit_step.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int kMaxTurns = 8;
constexpr int kThreadAim = 256;  // walk runs per step CTA, about
constexpr int kScatterThreads = 256;
constexpr int kGridThreads = 256;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// i modulo n for any int i and n > 0: the fast path takes the indices that
// are already on the board
__device__ __forceinline__ int wrap(int i, int n) {
    if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
    const int m = i % n;
    return m < 0 ? m + n : m;
}

struct Geometry {
    int rows, cols;  // the packed board, in words
    int tr, tc;      // a tile, in words
    int gr, gc;      // the grid of tiles
    int h;           // turns per block
    int capacity;    // slots of the list
};

// The step CTA's window and how its threads walk it: P = tr + 2 word rows
// by Q = tc + 2h columns, each row cut into `runs` runs of `len` (odd)
// consecutive columns, one run a thread; the row stride is runs x len, so
// the 32 lanes of a warp reading word len * lane + s of a row hit 32 banks.
struct Plan {
    int p, q, len, runs, stride, items, threads;
    size_t smem;
};

Plan make_plan(const Geometry& g) {
    Plan pl;
    pl.p = g.tr + 2;
    pl.q = g.tc + 2 * g.h;
    int runs = ceil_div(kThreadAim, pl.p);
    pl.len = ceil_div(pl.q, runs) | 1;
    // at most 1024 threads a block
    while (pl.p * ceil_div(pl.q, pl.len) > 1024) pl.len += 2;
    pl.runs = ceil_div(pl.q, pl.len);
    pl.stride = pl.runs * pl.len;
    pl.items = pl.p * pl.runs;
    pl.threads = ceil_div(pl.items, 32) * 32;
    pl.smem = 2 * static_cast<size_t>(pl.p) * pl.stride * sizeof(uint32_t);
    return pl;
}

__device__ __forceinline__ bool block_runs(const int* counts, int k, int capacity) {
    const int cnt = counts[k];
    return cnt >= 1 && cnt <= capacity;
}

template <class Rule>
__global__ void sparse_step_kernel(const uint32_t* __restrict__ board,
                                   uint32_t* __restrict__ scratch,
                                   uint8_t* __restrict__ changed_grid,
                                   const int* __restrict__ tiles,
                                   const int* __restrict__ counts, int k, Geometry g,
                                   Plan pl, Rule rule) {
    if (!block_runs(counts, k, g.capacity)) return;
    const int slot = blockIdx.x;
    if (slot >= counts[k]) return;  // the list's padding: no tile
    extern __shared__ uint32_t smem[];
    uint32_t* cur = smem;
    uint32_t* nxt = smem + pl.p * pl.stride;
    const int tile = tiles[slot];
    const int tile_r = tile / g.gc;
    const int r0 = tile_r * g.tr;
    const int c0 = (tile - tile_r * g.gc) * g.tc;

    for (int e = threadIdx.x; e < pl.p * pl.q; e += blockDim.x) {
        const int wr = e / pl.q;
        const int wc = e - wr * pl.q;
        const size_t br = wrap(r0 - 1 + wr, g.rows);
        const size_t bc = wrap(c0 - g.h + wc, g.cols);
        cur[wr * pl.stride + wc] = board[br * g.cols + bc];
    }

    // this thread's run: columns [j0, j0 + len) of window row i
    const int tid = threadIdx.x;
    const int i = tid / pl.runs;
    const int j0 = (tid - i * pl.runs) * pl.len;
    const bool active = tid < pl.items;
    const int m = (i == 0 ? 0 : i - 1) * pl.stride;  // the halo rows' outer
    const int c = i * pl.stride;                      // neighbour is the row
    const int p = (i + 1 == pl.p ? i : i + 1) * pl.stride;  // itself
    // the tile's columns of this run, when the run lies on a tile row
    const bool tile_row = active && i >= 1 && i <= g.tr;
    const int cs = max(j0, g.h);
    const int ce = min(j0 + pl.len, g.h + g.tc);
    __syncthreads();

    int changed = 0;
    for (int t = 1; t <= g.h; ++t) {
        // the cone: turn t steps columns t .. q - t - 1
        const int js = max(j0, t);
        const int je = min(j0 + pl.len, pl.q - t);
        if (active && js < je) {
            gol_walk(cur + m, cur + c, cur + p, nxt + c, js - 1, js, 1, je - js, je, rule);
        }
        int mine = 0;
        if (tile_row) {
            for (int j = cs; j < ce; ++j) mine |= nxt[c + j] != cur[c + j];
        }
        // the barrier of the turn: every word of nxt is written before any
        // thread reads it as cur
        changed |= __syncthreads_or(mine);
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    uint32_t* out = scratch + static_cast<size_t>(slot) * g.tr * g.tc;
    for (int e = threadIdx.x; e < g.tr * g.tc; e += blockDim.x) {
        const int r = e / g.tc;
        out[e] = cur[(1 + r) * pl.stride + g.h + e - r * g.tc];
    }
    if (threadIdx.x == 0) changed_grid[tile] = changed ? 1 : 0;
}

__global__ void __launch_bounds__(kScatterThreads)
sparse_scatter_kernel(uint32_t* __restrict__ board, const uint32_t* __restrict__ scratch,
                      const uint8_t* __restrict__ changed_grid,
                      const int* __restrict__ tiles, const int* __restrict__ counts, int k,
                      Geometry g) {
    if (!block_runs(counts, k, g.capacity)) return;
    const int slot = blockIdx.x;
    if (slot >= counts[k]) return;
    const int tile = tiles[slot];
    if (!changed_grid[tile]) return;  // its words are the board's already
    const int tile_r = tile / g.gc;
    const size_t r0 = static_cast<size_t>(tile_r) * g.tr;
    const size_t c0 = static_cast<size_t>(tile - tile_r * g.gc) * g.tc;
    const uint32_t* in = scratch + static_cast<size_t>(slot) * g.tr * g.tc;
    for (int e = threadIdx.x; e < g.tr * g.tc; e += blockDim.x) {
        const int r = e / g.tc;
        board[(r0 + r) * g.cols + c0 + e - r * g.tc] = in[e];
    }
}

// Append the tiles whose `active` is set to the list and count them into
// *count: one atomic a warp, the warp's tiles in lane order after it.
__device__ __forceinline__ void append_active(bool active, int tile, int* tiles, int* count,
                                              int capacity) {
    const unsigned ballot = __ballot_sync(0xffffffffu, active);
    if (ballot == 0) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, leader);
    const int slot = base + __popc(ballot & ((1u << lane) - 1u));
    if (active && slot < capacity) tiles[slot] = tile;
}

// The list of the dispatch's first block, from the grid it starts with.
__global__ void __launch_bounds__(kGridThreads)
sparse_list_kernel(const uint8_t* __restrict__ grid, int* __restrict__ tiles,
                   int* __restrict__ counts, Geometry g) {
    const int tile = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = tile < g.gr * g.gc && grid[tile] != 0;
    append_active(active, tile, tiles, &counts[0], g.capacity);
}

__global__ void __launch_bounds__(kGridThreads)
sparse_dilate_kernel(const uint8_t* __restrict__ changed_grid, uint8_t* __restrict__ grid,
                     int* __restrict__ tiles, int* __restrict__ counts, int k, Geometry g) {
    if (!block_runs(counts, k, g.capacity)) return;
    const int tile = blockIdx.x * blockDim.x + threadIdx.x;
    bool active = false;
    if (tile < g.gr * g.gc) {
        const int r = tile / g.gc;
        const int c = tile - r * g.gc;
        for (int dr = -1; dr <= 1 && !active; ++dr) {
            const int row = wrap(r + dr, g.gr) * g.gc;
            for (int dc = -1; dc <= 1; ++dc) {
                if (changed_grid[row + wrap(c + dc, g.gc)]) {
                    active = true;
                    break;
                }
            }
        }
        grid[tile] = active ? 1 : 0;
    }
    append_active(active, tile, tiles, &counts[k + 1], g.capacity);
}

template <class Rule>
int launch_dispatch(uint32_t* board, uint8_t* grid, uint8_t* changed_grid, int* tiles,
                    uint32_t* scratch, int* counts, const Geometry& g, int n_blocks, Rule rule,
                    cudaStream_t stream) {
    const Plan pl = make_plan(g);
    static std::atomic<bool> opted[kMaxDevices];
    cudaError_t err = smem_opt_in_once(sparse_step_kernel<Rule>, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid_blocks = ceil_div(g.gr * g.gc, kGridThreads);
    sparse_list_kernel<<<grid_blocks, kGridThreads, 0, stream>>>(grid, tiles, counts, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    for (int k = 0; k < n_blocks; ++k) {
        sparse_step_kernel<Rule><<<g.capacity, pl.threads, pl.smem, stream>>>(
            board, scratch, changed_grid, tiles, counts, k, g, pl, rule);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
        sparse_scatter_kernel<<<g.capacity, kScatterThreads, 0, stream>>>(
            board, scratch, changed_grid, tiles, counts, k, g);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
        sparse_dilate_kernel<<<grid_blocks, kGridThreads, 0, stream>>>(
            changed_grid, grid, tiles, counts, k, g);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory a step CTA needs for this tile and h, in bytes, and
// its threads; the wrapper checks the bytes against the card's limit.
int gol_sparse_plan(int tr, int tc, int h, long long* smem_bytes, int* threads) {
    Geometry g{};
    g.tr = tr;
    g.tc = tc;
    g.h = h;
    const Plan pl = make_plan(g);
    *smem_bytes = static_cast<long long>(pl.smem);
    *threads = pl.threads;
    return 0;
}

// One dispatch: up to n_blocks blocks of h turns (1..8) of the rule given
// as (common, dead_only, live_only) T masks, on `board` (int32[rows, cols])
// and `grid` (uint8[rows / tr, cols / tc]), both in place. `counts`
// (int32[n_blocks + 1]) and `changed_grid` (uint8, the grid's size) must be
// zeroed; `tiles` holds `capacity` ints and `scratch` capacity x tr x tc
// words. Enqueues 1 + 3 n_blocks launches on `stream` and returns
// cudaGetLastError() after them (0 on success); cudaErrorInvalidValue for
// a geometry the kernel does not take.
int gol_sparse_dispatch(void* board, void* grid, void* changed_grid, void* tiles, void* scratch,
                        void* counts, int rows, int cols, int tr, int tc, int h, int capacity,
                        int n_blocks, unsigned common, unsigned dead_only, unsigned live_only,
                        void* stream) {
    if (rows <= 0 || cols <= 0 || tr <= 0 || tc <= 0 || rows % tr || cols % tc ||
        h < 1 || h > kMaxTurns || capacity < 1 || n_blocks < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Geometry g{rows, cols, tr, tc, rows / tr, cols / tc, h, capacity};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return gol_with_rule(common, dead_only, live_only, [&](auto rule) {
        return launch_dispatch(static_cast<uint32_t*>(board), static_cast<uint8_t*>(grid),
                               static_cast<uint8_t*>(changed_grid), static_cast<int*>(tiles),
                               static_cast<uint32_t*>(scratch), static_cast<int*>(counts), g,
                               n_blocks, rule, s);
    });
}

}  // extern "C"

static_assert(kMaxTurns < 32, "one halo word row covers fewer than 32 turns");
