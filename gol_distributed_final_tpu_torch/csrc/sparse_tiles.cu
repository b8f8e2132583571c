// The activity-sparse step: blocks of h <= 8 turns of a life-like rule
// without birth on 0 neighbours, computed only on the active tiles of a
// packed int32 board [rows, cols] (word axis 0: bit j of word (r, c) is
// cell (32 r + j, c)), on the torus.
//
// Replaces the XLA program of the JAX package's activity-sparse plane,
// gol_distributed_final_tpu/ops/sparse.py:189 (_sparse_program): its
// lax.while_loop of gather, h bit_steps on the gathered batch, scatter and
// a dilated change grid. There it is one dispatch per step_n piece; here it
// is one cooperative launch, the port's counterpart of that loop: the loop,
// its active list and its activity state stay on the card from the first
// block to the last, and the host reads the counts once, at the end
// (ops/sparse_tiles.py).
//
// The function. Block k runs only while k < n_blocks and 1 <= counts[k] <=
// capacity, counts[k] being the active tiles block k starts from (the
// reference's `cnt`): a count past the capacity is its overflow, which
// commits nothing, and a count of 0 an empty grid. A block that does not
// run ends the dispatch, so the counts past it stay 0 and the host finds
// where the loop stopped from them alone. A block steps each active tile h
// turns in a window of one word row above and below and h columns each
// side (indices modulo the board), ORs each turn's change of the tile into
// its flag (an oscillator whose period divides h stays active,
// ops/sparse.py:232-236 of the reference), commits the changed tiles, and
// the next block's tiles are those with a changed tile among their 9
// neighbours on the torus of tiles. The returned grid is the active set
// that the block which did not run started from: after an overflow the
// grid the overflowing block started from, after a drain all false.
//
// The design: persistent CTAs, one barrier a block. The grid is launched
// cooperatively, so cg::this_grid().sync() is a barrier that every CTA
// reaches; a CTA walks the block's work items blockIdx.x, + gridDim.x, ...
// Phases:
// 0. zero the counts; barrier;
// 1. from the input grid, every tile's stamp (1 when active, else 0), its
//    two change records cleared, and list 0 appended into counts[0];
//    barrier;
// then for each block k, one phase and one barrier:
// 2. scatter: the tiles of block k - 1 that changed, from that block's
//    scratch into the board (by the CTAs from the grid's far end, which
//    step nothing while the frontier is under half the grid);
// 3. step: each tile of list k from its window into scratch[k % 2][slot],
//    where a window word whose tile changed in block k - 1 is read from
//    that block's scratch, not from the board, which the scatter is still
//    writing. A changed tile records {k + 1, slot} for block k + 1's
//    readers, sets its slot's flag, and marks its 9 neighbours with
//    atomicMax(stamp, k + 2): the first mark of a tile appends it to list
//    k + 1 (its flag there set to -1) and counts it into counts[k + 1];
//    slots past the capacity are not written, but every stamp is, so the
//    grid stays complete on an overflow.
// After the barrier every CTA reads counts[k + 1], so all take the same
// decision: when block k + 1 does not run, the last phase scatters block
// k's changes, writes the output grid (stamp == k + 2) and returns.
//
// Parts. A block's time is one tile's h turns, a block barrier each, on
// one SM, so a small frontier is stepped in 4 (or 2) parts of each tile's
// columns, one CTA a part, each with its own cone of h columns each side:
// the most parts that keep every part in one wave of the grid. Every part
// writes its columns to the slot's scratch, and a part that changed sets
// the tile's record, flag and marks, so the tile is changed when any part
// is, as the reference's flag is the OR over the tile. The flags of list
// k + 1 are reset while list k's are set and block k - 1's are read, so
// they alternate over three buffers. A part ORs its change over its turns
// and threads once, after the last turn, so each turn ends on a plain
// block barrier.
//
// The grid. As many CTAs as the card holds at once at the kernel's threads
// and shared memory (the occupancy API x the SMs), capped near what the
// frontier needs: half the capacity (the plane's bucket holds about twice
// its count), but one an SM while the capacity's parts ask for it, and
// never more than those parts. CTAs past the SMs' count share an SM with
// a stepping one, which a small frontier pays for.
//
// Threads. A window row is walked in runs of an odd number of words, one
// run a thread, aiming at 512 walk runs: runs of 3 words on 480 threads
// for the default tile's whole window (8 x 128 words, h = 8), of 1 word on
// 480 threads for its quarters.
//
// Measured (chip_smoke.py --sparse-sweep, NVIDIA H100 80GB HBM3, 700 W;
// PERF.md): on the R-pentomino after 1000 turns at 16384^2 (22 tiles), a
// block takes 8.3 us as committed, 9.8-9.9 us with the tiles whole,
// 12.1-12.2 us whole on 224 threads, 8.7 us with an OR barrier every
// turn; whole tiles on 48 to 132 CTAs 9.7-9.95 us, on 160 to 264 CTAs
// 13.6-14.0 us.
//
// Why this design. Stepping block k while block k - 1 is scattered is
// exact because the scatter writes only tiles that changed in block k - 1,
// and a window reads those from block k - 1's scratch; every other word of
// the board already holds its value at the start of block k: a tile that
// did not change in block k - 1 (not stepped, or stepped to the same
// words) kept what the earlier scatters, each finished before a barrier,
// left in it. Membership comes from the stamps and not from the list's order,
// which atomics vary from run to run: each tile's output depends only on
// the board, and active_sum and count are counts, so every result is the
// same in every run. The alternatives: (a) step into scratch, barrier,
// scatter and mark, barrier: two barriers a block; (b) two whole boards,
// stepping X into Y with one barrier a block, exact because Y already holds
// every tile that did not change in the block before, but it copies the
// whole board once more a dispatch (512 MB at 65536^2, ~0.3 ms at 3.35
// TB/s, against a barrier of a few microseconds; the main path makes tens
// of dispatches of tens of blocks). This design keeps (b)'s one barrier a
// block at (a)'s one board copy (the wrapper's, which is the returned
// board), for a lookup of 3 x (2 ceil(h / tc) + 1) change records a
// window. Two scratch buffers, two change records a tile and two lists
// alternate by block parity, so what phase k writes is never what it reads.
//
// Hazards. Everything that a CTA writes during the launch (board, scratch,
// lists, counts, stamps, change records) is read with __ldcg, at L2, and
// never through a const __restrict__ pointer or __ldg, whose non-coherent
// path may return stale words after a grid barrier. Every thread of every
// CTA reaches every grid barrier: the run-or-stop decision is read by all
// after the same barrier, the walks over slots and tiles are uniform
// within a CTA, and no thread returns early. A dispatch may take
// ops/sparse.py::_MAX_BLOCKS_PER_DISPATCH = 8192 blocks, one launch of tens
// of milliseconds: fine on a headless H100 (no display watchdog).
//
// What bounds it. Per block the card reads each active tile's window and
// writes the tiles that changed, and does ops/bitpack.py::ops_per_word
// int32 instructions per word per turn over the active tiles' words; at the
// frontiers the main path gives it (tens to hundreds of 8 x 128-word tiles)
// either is well under a microsecond, so a block costs its latency: a
// part's window load (after a lookup of the change records), its h turns
// with a block barrier each, its store and marks, and one grid barrier.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "bit_step.cuh"
#include "smem_opt_in.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxTurns = 8;
constexpr int kThreadAim = 512;  // walk runs per CTA, about (see "Threads" above)
constexpr int kTableInts = 64;   // the window's source table: 3 x (2 * 8 + 1) at most
constexpr int kSplits = 3;       // a tile in 1, 2 or 4 parts of its columns
constexpr int kDone = 3;         // the slots' change flags, by block modulo 3

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
    int reach;       // ceil(h / tc): tile columns a window reaches each side
    int capacity;    // slots of a list
    int n_blocks;
};

// A part's window and how a CTA's threads walk it: P = tr + 2 word rows by
// Q = tc / parts + 2h columns, each row cut into `runs` runs of `len` (odd)
// consecutive columns, one run a thread; the row stride is runs x len, so
// the 32 lanes of a warp reading word len * lane + s of a row hit 32 banks.
struct Plan {
    int p, q, len, runs, stride, items;
};

// The plans of a tile in 1, 2 and 4 parts (index log2 of the parts; a
// split that does not divide tc is never taken), and the CTA they share:
// the most threads and shared memory any of them needs.
struct Plans {
    Plan of[kSplits];
    int threads;
    size_t smem;
};

Plan make_plan(int tr, int width, int h) {
    Plan pl;
    pl.p = tr + 2;
    pl.q = width + 2 * h;
    const int runs = ceil_div(kThreadAim, pl.p);
    pl.len = ceil_div(pl.q, runs) | 1;
    // at most 1024 threads a block
    while (pl.p * ceil_div(pl.q, pl.len) > 1024) pl.len += 2;
    pl.runs = ceil_div(pl.q, pl.len);
    pl.stride = pl.runs * pl.len;
    pl.items = pl.p * pl.runs;
    return pl;
}

Plans make_plans(int tr, int tc, int h) {
    Plans ps;
    ps.threads = 0;
    ps.smem = 0;
    for (int i = 0; i < kSplits; ++i) {
        const int parts = 1 << i;
        ps.of[i] = make_plan(tr, tc % parts ? tc : tc / parts, h);
        const size_t smem =
            (kTableInts + 2 * static_cast<size_t>(ps.of[i].p) * ps.of[i].stride) *
            sizeof(uint32_t);
        ps.threads = std::max(ps.threads, ceil_div(ps.of[i].items, 32) * 32);
        ps.smem = std::max(ps.smem, smem);
    }
    return ps;
}

// The launch's state on the card. The board and the output grid are the
// wrapper's fresh tensors; the rest lives in its cached workspace.
struct Buffers {
    uint32_t* board;        // the dispatch's board, in place
    const uint8_t* grid_in; // the activity grid the dispatch starts from (never written)
    uint8_t* grid_out;      // the grid it returns, every byte written
    int* counts;            // n_blocks + 1: counts[k] = list k's tiles
    uint32_t* scratch;      // 2 x capacity x tr x tc words: block k's tiles at k % 2
    int2* changed;          // 2 x tiles: {k + 1, slot} when the tile changed in block k
    int* stamp;             // tiles: k + 1 when the tile is on list k, the latest
    int* list;              // 2 x capacity: list k at k % 2
    int* done;              // 3 x capacity: at k % 3, the tile of a slot of list k
                            // that changed in block k, else -1
};

struct Layout {
    size_t changed, stamp, list, done, total;  // byte offsets; scratch at 0
};

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

Layout make_layout(const Geometry& g) {
    const size_t tiles = static_cast<size_t>(g.gr) * g.gc;
    const size_t cap = static_cast<size_t>(g.capacity);
    Layout l;
    l.changed = align256(2 * cap * g.tr * g.tc * sizeof(uint32_t));
    l.stamp = l.changed + align256(2 * tiles * sizeof(int2));
    l.list = l.stamp + align256(tiles * sizeof(int));
    l.done = l.list + align256(2 * cap * sizeof(int));
    l.total = l.done + align256(kDone * cap * sizeof(int));
    return l;
}

// Append the tiles whose `active` is set to `list` and count them into
// *count: one atomic a warp, the warp's tiles in lane order after it; a
// slot written also has its change flag in `done` set to -1. Every lane of
// the warp calls it.
__device__ __forceinline__ void append_active(bool active, int tile, int* list, int* done,
                                              int* count, int capacity) {
    const unsigned ballot = __ballot_sync(0xffffffffu, active);
    if (ballot == 0) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, leader);
    const int slot = base + __popc(ballot & ((1u << lane) - 1u));
    if (active && slot < capacity) {
        list[slot] = tile;
        done[slot] = -1;
    }
}

// Phase 1: stamps and change records from the input grid, and list 0. The
// walk is uniform in a CTA, so every lane of a warp reaches the append.
__device__ void first_list(const Buffers& b, const Geometry& g) {
    const int tiles = g.gr * g.gc;
    for (int base = blockIdx.x * blockDim.x; base < tiles; base += gridDim.x * blockDim.x) {
        const int t = base + threadIdx.x;
        const bool active = t < tiles && b.grid_in[t] != 0;
        if (t < tiles) {
            b.stamp[t] = active ? 1 : 0;
            b.changed[t] = make_int2(0, 0);
            b.changed[tiles + t] = make_int2(0, 0);
        }
        append_active(active, t, b.list, b.done, &b.counts[0], g.capacity);
    }
}

// Phase 2: the tiles of block `k` that changed, from its scratch into the
// board; slots walked from the grid's far end.
__device__ void scatter_block(const Buffers& b, const Geometry& g, int k) {
    const int count = __ldcg(&b.counts[k]);  // <= capacity: block k ran
    const int words = g.tr * g.tc;
    for (int slot = gridDim.x - 1 - blockIdx.x; slot < count; slot += gridDim.x) {
        const int tile = __ldcg(&b.done[(k % kDone) * g.capacity + slot]);
        if (tile < 0) continue;  // unchanged: the board holds its words
        const int tile_r = tile / g.gc;
        const size_t r0 = static_cast<size_t>(tile_r) * g.tr;
        const size_t c0 = static_cast<size_t>(tile - tile_r * g.gc) * g.tc;
        const uint32_t* in =
            b.scratch + (static_cast<size_t>(k & 1) * g.capacity + slot) * words;
        for (int e = threadIdx.x; e < words; e += blockDim.x) {
            const int r = e / g.tc;
            b.board[(r0 + r) * g.cols + c0 + e - r * g.tc] = __ldcg(in + e);
        }
    }
}

// Phase 3 for one part of one slot of list k: the part's columns of the
// tile, h turns on, into the slot's scratch; when any of them changed, the
// tile's change record and flag, and its neighbours marked for list k + 1.
template <class Rule>
__device__ void step_part(const Buffers& b, const Geometry& g, const Plan& pl,
                          const Rule& rule, int k, int slot, int part, int width,
                          uint32_t* smem) {
    const int parity = k & 1;
    const int tiles = g.gr * g.gc;
    const int words = g.tr * g.tc;
    int* table = reinterpret_cast<int*>(smem);
    uint32_t* cur = smem + kTableInts;
    uint32_t* nxt = cur + pl.p * pl.stride;
    __syncthreads();  // the previous part's window and table are read out
    const int tile = __ldcg(&b.list[parity * g.capacity + slot]);
    const int tile_r = tile / g.gc;
    const int tile_c = tile - tile_r * g.gc;
    const int r0 = tile_r * g.tr;
    const int c0 = tile_c * g.tc;
    const int pc0 = part * width;  // the part's first column in the tile

    // which tiles under the window changed in block k - 1: their slots in
    // that block's scratch, else -1 (the board holds them)
    const int width3 = 2 * g.reach + 1;
    for (int i = threadIdx.x; i < 3 * width3; i += blockDim.x) {
        int src = -1;
        if (k > 0) {
            const int dr = i / width3 - 1;
            const int dc = i - (dr + 1) * width3 - g.reach;
            const int t = wrap(tile_r + dr, g.gr) * g.gc + wrap(tile_c + dc, g.gc);
            const int2 rec = __ldcg(&b.changed[(parity ^ 1) * tiles + t]);
            if (rec.x == k) src = rec.y;
        }
        table[i] = src;
    }
    __syncthreads();
    const uint32_t* prev = b.scratch + static_cast<size_t>(parity ^ 1) * g.capacity * words;
    for (int e = threadIdx.x; e < pl.p * pl.q; e += blockDim.x) {
        const int wr = e / pl.q;
        const int wc = e - wr * pl.q;
        // the window word's tile, relative to this one, and its place there
        const int row_of = wr == 0 ? 0 : (wr == g.tr + 1 ? 2 : 1);
        const int rin = wr == 0 ? g.tr - 1 : (wr == g.tr + 1 ? 0 : wr - 1);
        const int off = pc0 + wc - g.h;
        const int col_of = (off + g.reach * g.tc) / g.tc;  // floor(off / tc) + reach
        const int cin = off - (col_of - g.reach) * g.tc;
        const int src = table[row_of * width3 + col_of];
        uint32_t v;
        if (src >= 0) {
            v = __ldcg(prev + static_cast<size_t>(src) * words + rin * g.tc + cin);
        } else {
            const size_t br = wrap(r0 - 1 + wr, g.rows);
            const size_t bc = wrap(c0 + off, g.cols);
            v = __ldcg(b.board + br * g.cols + bc);
        }
        cur[wr * pl.stride + wc] = v;
    }

    // this thread's run: columns [j0, j0 + len) of window row i
    const int tid = threadIdx.x;
    const int i = tid / pl.runs;
    const int j0 = (tid - i * pl.runs) * pl.len;
    const bool active = tid < pl.items;
    const int m = (i == 0 ? 0 : i - 1) * pl.stride;  // the halo rows' outer
    const int c = i * pl.stride;                      // neighbour is the row
    const int p = (i + 1 == pl.p ? i : i + 1) * pl.stride;  // itself
    // the part's columns of this run, when the run lies on a tile row
    const bool tile_row = active && i >= 1 && i <= g.tr;
    const int cs = max(j0, g.h);
    const int ce = min(j0 + pl.len, g.h + width);
    __syncthreads();

    // the halo scheme of tiled.cu for word axis 0: the halo word rows are
    // stepped with their outer neighbour taken as themselves, which spoils
    // one outer bit a turn and never reaches the tile while h < 32; across
    // the columns the cone shrinks one word a turn
    int mine = 0;  // whether a word of the part in this thread's run changed
    for (int t = 1; t <= g.h; ++t) {
        // the cone: turn t steps columns t .. q - t - 1
        const int js = max(j0, t);
        const int je = min(j0 + pl.len, pl.q - t);
        if (active && js < je) {
            gol_walk(cur + m, cur + c, cur + p, nxt + c, js - 1, js, 1, je - js, je, rule);
        }
        if (tile_row) {
            for (int j = cs; j < ce; ++j) mine |= nxt[c + j] != cur[c + j];
        }
        // the barrier of the turn: every word of nxt is written before any
        // thread reads it as cur
        __syncthreads();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    // the OR over the turns and the threads, once: a plain barrier a turn
    const int changed = __syncthreads_or(mine);

    // every part writes its columns: the scatter copies the whole tile when
    // any part of it changed
    uint32_t* out = b.scratch + (static_cast<size_t>(parity) * g.capacity + slot) * words + pc0;
    for (int e = threadIdx.x; e < g.tr * width; e += blockDim.x) {
        const int r = e / width;
        out[r * g.tc + e - r * width] = cur[(1 + r) * pl.stride + g.h + e - r * width];
    }
    if (!changed) return;  // uniform in the CTA
    if (threadIdx.x == 0) {
        b.done[(k % kDone) * g.capacity + slot] = tile;
        b.changed[parity * tiles + tile] = make_int2(k + 1, slot);
    }
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int n = 0;
        bool first = false;
        if (lane < 9) {
            const int dr = lane / 3 - 1;
            const int dc = lane - (dr + 1) * 3 - 1;
            n = wrap(tile_r + dr, g.gr) * g.gc + wrap(tile_c + dc, g.gc);
            first = atomicMax(&b.stamp[n], k + 2) < k + 2;
        }
        append_active(first, n, b.list + (parity ^ 1) * g.capacity,
                      b.done + ((k + 1) % kDone) * g.capacity, &b.counts[k + 1], g.capacity);
    }
}

template <class Rule>
__global__ void sparse_blocks_kernel(Buffers b, Geometry g, Plans plans, Rule rule) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ uint32_t smem[];
    const int tiles = g.gr * g.gc;
    const int threads = gridDim.x * blockDim.x;
    const int gtid = blockIdx.x * blockDim.x + threadIdx.x;

    for (int i = gtid; i <= g.n_blocks; i += threads) b.counts[i] = 0;
    grid.sync();
    first_list(b, g);
    grid.sync();
    for (int k = 0;; ++k) {
        const int count = __ldcg(&b.counts[k]);
        const bool runs = k < g.n_blocks && count >= 1 && count <= g.capacity;
        if (k > 0) scatter_block(b, g, k - 1);
        if (!runs) {
            // the grid block k started from: the tiles stamped for list k
            for (int t = gtid; t < tiles; t += threads) {
                b.grid_out[t] = __ldcg(&b.stamp[t]) == k + 1 ? 1 : 0;
            }
            return;
        }
        // a small frontier in parts of the tiles' columns, as many as keep
        // every part in one wave of the grid
        int split = kSplits - 1;
        while (split > 0 && ((g.tc & ((1 << split) - 1)) != 0 ||
                             static_cast<long long>(count) << split > gridDim.x)) {
            --split;
        }
        const int parts = 1 << split;
        const int width = g.tc >> split;
        // constant indices: a run-time index into the parameter would copy
        // the plans to the stack
        Plan pl = plans.of[0];
        if (split == 1) pl = plans.of[1];
        if (split == 2) pl = plans.of[2];
        for (int item = blockIdx.x; item < count * parts; item += gridDim.x) {
            const int part = item / count;
            step_part(b, g, pl, rule, k, item - part * count, part, width, smem);
        }
        grid.sync();
    }
}

// The CTAs of a launch (see "The design" above): at most as many as the
// card holds at once at the plans' threads and shared memory (the
// occupancy API x the SMs), about half the capacity (the plane's bucket
// holds twice its count), at least one an SM while the capacity's parts
// need them, and never more than the parts of a full list. The shared-memory
// opt-in comes first: the occupancy query sizes the grid at it.
template <class Rule>
cudaError_t resident_ctas(const Plans& ps, int capacity, int* ctas) {
    auto* kernel = sparse_blocks_kernel<Rule>;
    static std::atomic<bool> opted[kMaxDevices];
    cudaError_t err = smem_opt_in_once(kernel, opted);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ps.threads, ps.smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long cap = capacity;
    const long long want = std::max((cap + 1) / 2, std::min(cap << (kSplits - 1),
                                                              static_cast<long long>(sms)));
    *ctas = static_cast<int>(std::min(want, static_cast<long long>(per_sm) * sms));
    return cudaSuccess;
}

template <class Rule>
int launch_dispatch(Buffers b, Geometry g, Rule rule, cudaStream_t stream) {
    Plans ps = make_plans(g.tr, g.tc, g.h);
    int ctas = 0;
    cudaError_t err = resident_ctas<Rule>(ps, g.capacity, &ctas);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&b, &g, &ps, &rule};
    // a grid the card cannot hold at once comes back as
    // cudaErrorCooperativeLaunchTooLarge, never as a launch
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sparse_blocks_kernel<Rule>),
                                      dim3(ctas), dim3(ps.threads), args, ps.smem, stream);
    return static_cast<int>(err);
}

bool geometry_ok(int rows, int cols, int tr, int tc, int h, int capacity, int n_blocks) {
    return rows > 0 && cols > 0 && tr > 0 && tc > 0 && rows % tr == 0 && cols % tc == 0 &&
           h >= 1 && h <= kMaxTurns && capacity >= 1 && n_blocks >= 0 &&
           n_blocks < 0x7fffffff - 2;
}

Geometry make_geometry(int rows, int cols, int tr, int tc, int h, int capacity,
                       int n_blocks) {
    return Geometry{rows, cols, tr, tc, rows / tr, cols / tc, h, ceil_div(h, tc),
                    capacity, n_blocks};
}

}  // namespace

extern "C" {

// Dynamic shared memory a CTA needs for this tile and h, in bytes, and its
// threads; the wrapper checks the bytes against the card's limit.
int gol_sparse_plan(int tr, int tc, int h, long long* smem_bytes, int* threads) {
    const Plans ps = make_plans(tr, tc, h);
    *smem_bytes = static_cast<long long>(ps.smem);
    *threads = ps.threads;
    return 0;
}

// The CTAs a dispatch of this tile, h, capacity and rule launches on the
// current device (resident_ctas).
int gol_sparse_ctas(int tr, int tc, int h, int capacity, unsigned common, unsigned dead_only,
                    unsigned live_only, int* ctas) {
    if (!geometry_ok(tr, tc, tr, tc, h, capacity, 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Plans ps = make_plans(tr, tc, h);
    return gol_with_rule(common, dead_only, live_only, [&](auto rule) {
        return static_cast<int>(resident_ctas<decltype(rule)>(ps, capacity, ctas));
    });
}

// Bytes of the workspace a dispatch of this geometry and capacity needs:
// the scratch, the change records, the stamps, the lists and the slots'
// flags. Nothing in it outlives a dispatch, so one workspace serves every
// dispatch of the geometry on one stream.
int gol_sparse_workspace_bytes(int rows, int cols, int tr, int tc, int capacity,
                               long long* bytes) {
    if (!geometry_ok(rows, cols, tr, tc, 1, capacity, 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    *bytes = static_cast<long long>(
        make_layout(make_geometry(rows, cols, tr, tc, 1, capacity, 0)).total);
    return 0;
}

// One dispatch: up to n_blocks blocks of h turns (1..8) of the rule given
// as (common, dead_only, live_only) T masks, on `board` (int32[rows, cols],
// written in place) from the activity grid `grid_in` (uint8[rows / tr,
// cols / tc], only read); `grid_out` (the grid's size) receives the grid
// the dispatch returns, `counts` (int32[n_blocks + 1]) the active tiles
// each block started from, counts[k] = 0 past the last block that ran, and
// `workspace` is gol_sparse_workspace_bytes of scratch. Nothing needs
// zeroing first. Enqueues exactly one launch on `stream`, a cooperative
// one, and returns its error (0 on success, cudaErrorCooperativeLaunchTooLarge
// for a grid the card cannot hold at once); cudaErrorInvalidValue for a
// geometry the kernel does not take.
int gol_sparse_dispatch(void* board, void* grid_in, void* grid_out, void* counts,
                        void* workspace, int rows, int cols, int tr, int tc, int h,
                        int capacity, int n_blocks, unsigned common, unsigned dead_only,
                        unsigned live_only, void* stream) {
    if (!geometry_ok(rows, cols, tr, tc, h, capacity, n_blocks)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Geometry g = make_geometry(rows, cols, tr, tc, h, capacity, n_blocks);
    const Layout l = make_layout(g);
    char* ws = static_cast<char*>(workspace);
    Buffers b;
    b.board = static_cast<uint32_t*>(board);
    b.grid_in = static_cast<const uint8_t*>(grid_in);
    b.grid_out = static_cast<uint8_t*>(grid_out);
    b.counts = static_cast<int*>(counts);
    b.scratch = reinterpret_cast<uint32_t*>(ws);
    b.changed = reinterpret_cast<int2*>(ws + l.changed);
    b.stamp = reinterpret_cast<int*>(ws + l.stamp);
    b.list = reinterpret_cast<int*>(ws + l.list);
    b.done = reinterpret_cast<int*>(ws + l.done);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return gol_with_rule(common, dead_only, live_only,
                         [&](auto rule) { return launch_dispatch(b, g, rule, s); });
}

}  // extern "C"

static_assert(kMaxTurns < 32, "one halo word row covers fewer than 32 turns");
static_assert(3 * (2 * kMaxTurns + 1) <= kTableInts, "the source table holds every tile");
static_assert(kSplits == 3, "the kernel selects the plan of each split by a constant index");
