// The whole-board bitboard kernels: n turns of any B/S rule on packed
// boards, each held in one thread block's shared memory, plus each board's
// row popcounts, or its alive count after every turn (history mode, below),
// in one launch. The grid runs over a batch of B independent boards
// (universes); a single board is the batch of one, and runs instead on a
// thread block cluster, cut into bands (the cluster route, below).
//
// Replaces two Pallas kernels of the JAX package:
// K1, gol_distributed_final_tpu/ops/pallas_stencil.py:217 (bit_pallas_call,
// body _bit_kernel at :178) and the popcount that ops/fused.py:523
// (_fused_bit_counted_compiled) adds after it; and K2, ops/pallas_stencil.py
// :298 (bit_batch_pallas_call, body _bit_kernel_batch at :275, grid=(B,))
// and the per-universe popcount that ops/fused.py:543
// (_fused_batch_counted_compiled) adds after it.
//
// What bounds it. Device memory is touched twice per launch, so bytes never
// bound it: the int32 instruction rate does, 12 instructions per word per
// turn for Conway at the least (ops/bitpack.py::ops_per_word). One board on
// one block reaches at most 1/132 of the card, hence the cluster route for
// a batch of one; a batch fills the card with blocks, and then what a block
// spends per word and how many blocks reside per SM set the time.
//
// Design of the one-block kernel. Block b owns board b: it reads the board's words from device
// memory once, runs all n turns in dynamic shared memory (two copies of the
// board, ping-ponged, one __syncthreads() per turn: a whole board turns in
// lockstep) and writes the board and its int32 row popcounts once. n and the
// rule's masks are run-time arguments; the rule is also a template parameter
// (bit_step.cuh), so the four named rules run a select folded at compile
// time. Per turn each thread walks its run of `run_len` consecutive lines
// at one packed index with bit_step.cuh's sliding window (3 loads and one
// packed-axis sum per word); the run, its wrapped neighbour offsets and its
// torus wrap are computed once, before the turn loop, so the loop holds no
// division. run_len is odd: neighbouring lanes then hit distinct shared
// memory banks in both packings (word axis 0: lanes take runs of one row,
// L words apart; word axis 1: lanes take packed indices, and where a row is
// narrower than a warp, rows L apart).
//
// The block size, chosen at launch (plan below): resident blocks per SM are
// the batch over the SMs, capped by shared memory; a block aims at a
// quarter of the SM's 2048 threads shared among those, and run_len is the
// smallest odd length that keeps it within that. A run of L words makes
// L + 2 packed-axis sums, so longer runs share more of them, while the
// other three quarters of the SM's threads are left to the blocks' latency.
// So 1000 boards of 128^2 (8 an SM, all resident at once) take runs of 9
// words, 60 runs in a block of 64 threads; the broker's session batches of
// <= 256 boards (2 an SM) take runs of 3, 172 runs in 192 threads; one 512^2
// board takes runs of 17, 496 runs in 512 threads. A sweep of run lengths
// on the H100 chose the quarter (shorter runs, for a block of the SM's full
// share, were slower at 1000 x 128^2 and at one 512^2 board, and no faster
// at 256 x 128^2); PERF.md's kernel table has the times (chip_smoke.py).
//
// The cluster route, for a batch of one: one block reaches 1/132 of the
// card, so a lone board is cut into bands over a thread block cluster of C
// blocks, each on its own SM, with K5's band-and-halo scheme (byte_board.cu's
// bit form). Block b holds the band of Q / C lines from b * Q / C (the axis
// that is not packed) plus d halo lines on each side. Every d turns each
// block takes its neighbours' band edges through distributed shared memory
// (a meeting); a last phase of n % d turns. The torus closes
// across the lines through the ring, along the packed axis inside each
// block. The first halo is read from device memory; each block writes its
// own band once. In shared memory a line's words lie side by side in both
// packings (word axis 0 is transposed as it is loaded and stored), so the
// turn loops are the same for both. Row popcounts: under word axis 1 a row
// is a line and a block's rows are its own; under word axis 0 a row crosses
// every band, so each block puts its band's part of every row into shared
// memory no other block reads, the cluster meets, block b adds up the parts
// of rows b, b + C, ... from every block through distributed shared memory
// and writes them, and the cluster meets again before any block leaves:
// exact, with no atomics and no zeroed vector.
//
// Between two meetings a block runs its turns in one of two loops.
// - The register loop (whole_board_cluster_registers_kernel), for a line of
//   P <= 32 words: a line lies across P lanes of a warp, 32 / P line
//   columns a warp, and each thread holds R consecutive lines at its packed
//   index in registers for all n turns (R a template parameter). A turn
//   makes each line's packed-axis sum once, with the packed neighbours by
//   __shfl_sync (the torus wrapped in the source lane); the lines above and
//   below a thread's stack come by shuffle from the warp's neighbouring
//   column, and at a warp's ends from the neighbouring warps' edge line
//   sums in shared memory, double-buffered by the turn's parity, so the
//   turn needs one __syncthreads(). A warp whose lines have all left the
//   phase's cone steps nothing. Edited copies on the H100 chose this
//   hand-off between warps over ones with no block-wide barrier (PERF.md):
//   at 512^2 each warp meeting its two neighbours at named barriers of 64
//   threads measured 8% slower a launch, mbarriers 15-20%, turn counts in
//   shared memory with release and acquire 30%, and warp halos refreshed
//   every 2 or 4 turns, with no trade between, 30% or more; with no
//   hand-off at all (a wrong result) the loop was 20% faster, so the
//   barrier is not what a turn costs.
//   Between phases a block meets only its two neighbours: the threads
//   holding the band's first and last d lines push them into the halo
//   slots of the block above and the block below through distributed
//   shared memory (st.async, four lines a 16-byte store where they lie
//   aligned, each store counted on the receiver's mbarrier), and each
//   block waits on its own mbarrier for its 2 d lines of halo, then loads
//   them from its own shared memory. No block waits for the rest of the
//   cluster, and no remote read follows the wait: at 512^2 a meeting took
//   0.36 us against 0.89 for a cluster barrier and remote reads, and plain
//   remote stores with one remote mbarrier arrival a warp were slower
//   than either (PERF.md). The halo slots and the mbarriers are
//   double-buffered by the meeting's parity, which is enough: a block
//   pushes at meeting m + 2 only after stepping the phase that needed its
//   neighbour's push of meeting m + 1, and that neighbour pushed it only
//   after loading its halo of meeting m from the same slots. So a sender
//   is at most one meeting ahead of its receiver, and every push into a
//   block is waited for by that block before it leaves the loop; a split
//   cluster barrier after the last meeting keeps every block resident
//   until every push has landed. On a cluster of 2 both neighbours are one
//   block, which takes both pushes.
// - The shared-memory loop (whole_board_cluster_kernel), for a line past a
//   warp or a band no block of at most kRegMaxThreads holds: two copies
//   of the slots, one __syncthreads() between turns, each turn walking
//   the shrinking cone (bit_step.cuh's gol_walk), and two meetings a phase.
//
// ops/whole_board.py::cluster_plan chooses C, d, the loop and its block by
// the board, from the sweep, and hands the route to the entry point, which
// runs it; a cluster launch the card refuses runs the one-block kernel
// instead. A batch above one (K2) and the history mode stay on one
// block a board: a batch already fills the card with blocks, and the
// history mode is off the sessions' path.
//
// History mode (the port of ops/bitpack.py:363 alive_history, an XLA
// lax.scan of bit_step plus a popcount in the JAX package): the same launch
// also writes int32 turn_counts[b][t], board b's alive count after turn
// t + 1, for t < n, keeping the board on chip for all n turns. The block
// zeroes its counts before its first barrier; then each thread adds up
// __popc of the words its walk writes, a warp reduces that
// (__reduce_add_sync), and lane 0 adds the warp's sum into the turn's count
// with one atomicAdd to device memory, which nothing waits on. So the turn
// keeps its one __syncthreads and the mode needs no shared memory of its
// own: a board under the gate is under it in both modes. A board under the
// gate holds under a million cells, so int32 sums cannot overflow. The mode
// is a template parameter chosen by a non-null turn_counts: in the launches
// without it the counts fold away at compile time.
//
// The gate, per board: both copies must fit the block's opt-in shared
// memory (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 B on an H100),
// so 8 * rows * cols <= that limit (ops/whole_board.py::fits).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "bit_step.cuh"
#include "smem_opt_in.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;        // the largest block plan() chooses
constexpr int kClusterThreadAim = 512;  // runs per block of the shared-memory loop, about
constexpr int kRegMaxWords = 32;         // the register loop's line lies on one warp's lanes
constexpr int kRegMaxThreads = 512;      // its largest block up to 4 lines a thread: 128 registers
constexpr int kRegMaxThreadsWide = 384;  // and with 8 lines a thread: 168 registers

// The largest block of the register loop with R lines a thread: the SM's
// 65,536 registers over its threads leave each enough for its R words and
// their sums, under any rule, with no spills (ops/whole_board.py::
// register_threads).
constexpr int register_threads(int R) { return R <= 4 ? kRegMaxThreads : kRegMaxThreadsWide; }

// The words between two packed indices' halo lines in the register loop's
// halo slots: `depth` in whole 16 bytes, an odd count of them.
__host__ __device__ constexpr int halo_pitch(int depth) {
    return ((depth + 3) / 4 | 1) * 4;
}

// One thread's share of a board: the lines [j0, j0 + len) at packed index
// i, as word offsets into a board copy.
struct Run {
    int m, c, p;         // packed index i-1, i, i+1 (wrapped) at line 0
    int prev_off, off;   // lines j0 - 1 (wrapped) and j0
    int last_next_off;   // line j0 + len (wrapped)
    int len;
};

template <int WORD_AXIS>
__device__ __forceinline__ Run make_run(int item, int rows, int cols, int run_len,
                                        int runs) {
    // P words along the packed axis, Q lines along the other
    const int P = WORD_AXIS == 0 ? rows : cols;
    const int Q = WORD_AXIS == 0 ? cols : rows;
    const int pstride = WORD_AXIS == 0 ? cols : 1;
    const int ostride = WORD_AXIS == 0 ? 1 : cols;
    // neighbouring lanes take neighbouring words of a board row: runs for
    // word axis 0, packed indices for word axis 1
    int i, r;
    if (WORD_AXIS == 0) {
        i = item / runs;
        r = item - i * runs;
    } else {
        r = item / P;
        i = item - r * P;
    }
    const int j0 = r * run_len;
    Run w;
    w.len = min(run_len, Q - j0);
    w.m = ((i == 0 ? P : i) - 1) * pstride;
    w.c = i * pstride;
    w.p = (i + 1 == P ? 0 : i + 1) * pstride;
    w.prev_off = ((j0 == 0 ? Q : j0) - 1) * ostride;
    w.off = j0 * ostride;
    const int jn = j0 + w.len;
    w.last_next_off = (jn == Q ? 0 : jn) * ostride;
    return w;
}

template <int WORD_AXIS, class Rule, bool HISTORY>
__global__ void __launch_bounds__(kMaxThreads)
whole_board_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   int32_t* __restrict__ row_counts, int32_t* __restrict__ turn_counts,
                   int rows, int cols, int n, int run_len, int runs, Rule rule) {
    extern __shared__ uint32_t smem[];
    const int total = rows * cols;
    // this block's board: the batch strides are whole boards and row vectors
    in += static_cast<size_t>(blockIdx.x) * total;
    out += static_cast<size_t>(blockIdx.x) * total;
    if (row_counts != nullptr) row_counts += static_cast<size_t>(blockIdx.x) * rows;
    if constexpr (HISTORY) {
        turn_counts += static_cast<size_t>(blockIdx.x) * n;
        for (int t = threadIdx.x; t < n; t += blockDim.x) turn_counts[t] = 0;
    }
    uint32_t* cur = smem;
    uint32_t* nxt = smem + total;
    for (int i = threadIdx.x; i < total; i += blockDim.x) cur[i] = in[i];

    const int ostride = WORD_AXIS == 0 ? 1 : cols;
    const int items = (WORD_AXIS == 0 ? rows : cols) * runs;
    const int tid = threadIdx.x;
    const Run own = make_run<WORD_AXIS>(tid, rows, cols, run_len, runs);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    for (int t = 0; t < n; ++t) {
        int pop = 0;
        if (tid < items) {
            pop += gol_walk<HISTORY>(cur + own.m, cur + own.c, cur + own.p, nxt + own.c,
                                     own.prev_off, own.off, ostride, own.len,
                                     own.last_next_off, rule);
        }
        // more runs than threads only where a board's packed axis is wider
        // than the largest block (> 1024 words)
        for (int item = tid + blockDim.x; item < items; item += blockDim.x) {
            const Run w = make_run<WORD_AXIS>(item, rows, cols, run_len, runs);
            pop += gol_walk<HISTORY>(cur + w.m, cur + w.c, cur + w.p, nxt + w.c, w.prev_off,
                                     w.off, ostride, w.len, w.last_next_off, rule);
        }
        if constexpr (HISTORY) {
            // blocks are whole warps, so every lane takes part
            pop = __reduce_add_sync(0xffffffffu, pop);
            if (lane == 0 && pop != 0) atomicAdd(turn_counts + t, pop);
        }
        __syncthreads();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    for (int i = threadIdx.x; i < total; i += blockDim.x) out[i] = cur[i];
    if (row_counts == nullptr) return;
    // one warp per row: strided __popc, then a shuffle reduction
    const int warps = blockDim.x >> 5;
    for (int r = threadIdx.x >> 5; r < rows; r += warps) {
        int sum = 0;
        for (int c = lane; c < cols; c += 32) sum += __popc(cur[r * cols + c]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) row_counts[r] = sum;
    }
}

// A thread's share of a band copy on the cluster route's shared-memory
// loop, as in K5's bit form (byte_board.cu), whose turn loop the cluster
// kernel repeats with the cluster's size a run-time argument. K5 keeps its
// own: K5 calling one shared loop measured 5% slower at 192^2 (0.0367
// against 0.0349 ms of device time a 100-turn launch; PERF.md).
namespace bands {

// The slots [j0, j0 + run_len) at packed index i.
struct Run {
    int m, c, p;  // packed index i-1, i, i+1, wrapped
    int j0;
};

__device__ __forceinline__ Run make_run(int item, int P, int run_len) {
    const int r = item / P;
    const int i = item - r * P;
    Run w;
    w.j0 = r * run_len;
    w.m = (i == 0 ? P : i) - 1;
    w.c = i;
    w.p = i + 1 == P ? 0 : i + 1;
    return w;
}

// The run's slots within [lo, hi) of `nxt` from `cur`, 1 <= lo <= hi <
// slots: the slots either side of them are read, never wrapped.
template <class Rule>
__device__ __forceinline__ void step_run(const Run& w, const uint32_t* cur, uint32_t* nxt,
                                         int P, int run_len, int lo, int hi, const Rule& rule) {
    const int js = max(w.j0, lo);
    const int je = min(w.j0 + run_len, hi);
    if (js < je) {
        gol_walk(cur + w.m, cur + w.c, cur + w.p, nxt + w.c, (js - 1) * P, js * P, P, je - js,
                 je * P, rule);
    }
}

// Block `rank`'s band of Q / cluster lines and `depth` halo lines on each
// side into `cur`, line-major: slot s holds line line0 - depth + s of the
// torus (depth <= band: one wrap at most); neighbouring threads read
// neighbouring words of device memory.
template <int WORD_AXIS>
__device__ __forceinline__ void load_slots(const uint32_t* __restrict__ in, uint32_t* cur,
                                           int cols, int P, int Q, int line0, int depth,
                                           int slots) {
    for (int e = threadIdx.x; e < slots * P; e += blockDim.x) {
        int s, i;
        if (WORD_AXIS == 0) {
            i = e / slots;
            s = e - i * slots;
        } else {
            s = e / P;
            i = e - s * P;
        }
        int line = line0 - depth + s;
        line = line < 0 ? line + Q : (line >= Q ? line - Q : line);
        cur[s * P + i] = WORD_AXIS == 0 ? in[i * cols + line] : in[line * cols + i];
    }
}

// The band (`own`, its `band` lines line-major) back to device memory,
// and unless row_counts is null the board's row popcounts, `part` holding
// P ints of the block's own shared memory that no other block reads. A
// block reads another's shared memory here only for the row popcounts
// under word axis 0, between two meetings of the cluster.
template <int WORD_AXIS>
__device__ __forceinline__ void store_band(const uint32_t* own, int32_t* part,
                                           uint32_t* __restrict__ out,
                                           int32_t* __restrict__ row_counts, int cols, int P,
                                           int band, int line0, int rank, int cluster,
                                           cg::cluster_group& group) {
    for (int e = threadIdx.x; e < band * P; e += blockDim.x) {
        if (WORD_AXIS == 0) {
            const int i = e / band;
            const int j = e - i * band;
            out[i * cols + line0 + j] = own[j * P + i];
        } else {
            out[line0 * cols + e] = own[e];
        }
    }
    if (row_counts == nullptr) return;

    // one warp per row (or per row's part): strided __popc, then a shuffle
    // reduction
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    if (WORD_AXIS == 1) {
        for (int j = threadIdx.x >> 5; j < band; j += warps) {
            int sum = 0;
            for (int i = lane; i < P; i += 32) sum += __popc(own[j * P + i]);
            sum = __reduce_add_sync(0xffffffffu, sum);
            if (lane == 0) row_counts[line0 + j] = sum;
        }
        return;
    }
    for (int i = threadIdx.x >> 5; i < P; i += warps) {
        int sum = 0;
        for (int j = lane; j < band; j += 32) sum += __popc(own[j * P + i]);
        sum = __reduce_add_sync(0xffffffffu, sum);
        if (lane == 0) part[i] = sum;
    }
    group.sync();
    for (int i = rank + cluster * static_cast<int>(threadIdx.x); i < P;
         i += cluster * static_cast<int>(blockDim.x)) {
        int sum = 0;
        for (int b = 0; b < cluster; ++b) sum += group.map_shared_rank(part, b)[i];
        row_counts[i] = sum;
    }
    // no block leaves while another reads its parts
    group.sync();
}

}  // namespace bands

// A band of one board on a cluster of `cluster` blocks, the shared-memory
// loop (the header comment): n turns, the band written back, and unless
// row_counts is null the board's row popcounts.
template <int WORD_AXIS, class Rule>
__global__ void __launch_bounds__(kMaxThreads)
whole_board_cluster_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                           int32_t* __restrict__ row_counts, int rows, int cols, int n,
                           int cluster, int depth, int run_len, int runs, Rule rule) {
    extern __shared__ uint32_t smem[];
    const int P = WORD_AXIS == 0 ? rows : cols;  // words per line
    const int Q = WORD_AXIS == 0 ? cols : rows;  // lines
    const int band = Q / cluster;
    cg::cluster_group group = cg::this_cluster();
    const int rank = static_cast<int>(group.block_rank());
    const int line0 = rank * band;
    const int slots = band + 2 * depth;
    uint32_t* cur = smem;
    uint32_t* nxt = smem + slots * P;
    bands::load_slots<WORD_AXIS>(in, cur, cols, P, Q, line0, depth, slots);

    // every block of the cluster is running before any reads another's
    // shared memory
    group.sync();

    const int items = P * runs;
    const int tid = threadIdx.x;
    const bands::Run mine = bands::make_run(tid, P, run_len);
    for (int left = n; left > 0;) {
        // A phase of r <= depth turns on the block's own copy: turn s steps
        // the slots that are still right, depth - r + s from either end, so
        // after turn r exactly the band is.
        const int r = min(depth, left);
        left -= r;
        for (int s = 1; s <= r; ++s) {
            const int lo = depth - r + s;
            const int hi = slots - lo;
            if (tid < items) bands::step_run(mine, cur, nxt, P, run_len, lo, hi, rule);
            // more runs than threads only for a band wider than the largest block
            for (int item = tid + blockDim.x; item < items; item += blockDim.x) {
                bands::step_run(bands::make_run(item, P, run_len), cur, nxt, P, run_len, lo, hi,
                                rule);
            }
            __syncthreads();
            uint32_t* tmp = cur;
            cur = nxt;
            nxt = tmp;
        }
        if (left > 0) {
            // The halo lines for the next phase, from the neighbours' bands
            // through distributed shared memory: the block above's last
            // `depth` lines and the block below's first. Two meetings a
            // phase: every band is finished before any is read, and every
            // halo is read before any band is stepped on.
            group.sync();
            const uint32_t* above = group.map_shared_rank(cur, rank == 0 ? cluster - 1 : rank - 1);
            const uint32_t* below = group.map_shared_rank(cur, rank + 1 == cluster ? 0 : rank + 1);
            for (int e = tid; e < depth * P; e += blockDim.x) {
                cur[e] = above[band * P + e];
                cur[(band + depth) * P + e] = below[depth * P + e];
            }
            group.sync();
        }
    }
    // the last read of another block's shared memory lies before the last
    // meeting
    bands::store_band<WORD_AXIS>(cur + depth * P, reinterpret_cast<int32_t*>(nxt), out,
                                 row_counts, cols, P, band, line0, rank, cluster, group);
}

// The register loop of the cluster route (the header comment): the slots
// of a block's band and halo cut into stacks of R lines, one stack a
// thread at one packed index, its words in registers for all n turns.
namespace regs {

constexpr unsigned kFull = 0xffffffffu;

// A thread's stack, the lanes it trades with and the shared memory its
// warp trades edge sums through, all fixed before the turn loop. A warp
// holds 32 / P line columns of R lines; the sums of its first and last
// lines lie at word `edges + parity * stride + (warp * 2 + side) * 2P + 2i`
// (two words: weights 1 and 2; side 0 the first line, side 1 the last),
// and each parity's 32 scratch slots follow its sums. A lane with no edge
// to put or take uses its own scratch slot, so the trade is the same
// instructions on every lane. Addresses are in the shared window, at
// parity 0.
struct Stack {
    bool live;             // the lane holds a line column (lanes past 32 / P do not)
    int i;                 // packed index
    int first;             // the slot of its first line (past the slots: garbage lines)
    int warp_first, warp_last;  // the slots of the warp's first and last lines
    int src_m, src_p;      // lanes holding packed index i-1 and i+1 of the same lines, wrapped
    int lane_up, lane_dn;  // lanes holding the warp's lines above and below the stack
    // where the lane puts its first and last line's sums, and gets the
    // neighbouring warps' edge sums above and below its stack
    unsigned put_first, put_last, get_up, get_dn;
    unsigned parity_bytes;  // from parity 0 to parity 1
    bool take_up, take_dn;  // the lane takes those sums in place of its shuffled ones
};

__device__ __forceinline__ unsigned shared_address(const uint32_t* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ Stack make_stack(int R, int P, uint32_t* edges, int stride) {
    Stack k;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int per_warp = 32 / P;
    const int col = lane / P;
    k.live = col < per_warp;
    k.i = k.live ? lane - col * P : 0;
    k.warp_first = warp * per_warp * R;
    k.warp_last = k.warp_first + per_warp * R - 1;
    k.first = k.warp_first + col * R;
    const int base = col * P;
    k.src_m = k.live ? base + (k.i == 0 ? P - 1 : k.i - 1) : lane;
    k.src_p = k.live ? base + (k.i + 1 == P ? 0 : k.i + 1) : lane;
    k.lane_up = k.live && col > 0 ? lane - P : lane;
    k.lane_dn = k.live && col + 1 < per_warp ? lane + P : lane;
    const bool top = k.live && col == 0;
    const bool bottom = k.live && col + 1 == per_warp;
    k.take_up = top && warp > 0;
    k.take_dn = bottom && warp + 1 < warps;
    const unsigned junk = shared_address(edges + 4 * warps * P + 2 * lane);
    auto slot = [&](int w, int side) {
        return shared_address(edges + ((w * 2 + side) * P + k.i) * 2);
    };
    k.put_first = top ? slot(warp, 0) : junk;
    k.put_last = bottom ? slot(warp, 1) : junk;
    k.get_up = k.take_up ? slot(warp - 1, 1) : junk;
    k.get_dn = k.take_dn ? slot(warp + 1, 0) : junk;
    k.parity_bytes = 4 * stride;
    return k;
}

__device__ __forceinline__ void put2(unsigned address, const GolLineSum& v) {
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(address), "r"(v.v0), "r"(v.v1)
                 : "memory");
}

__device__ __forceinline__ GolLineSum get2(unsigned address) {
    GolLineSum v;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.v0), "=r"(v.v1)
                 : "r"(address)
                 : "memory");
    return v;
}

// One turn of a thread's R words, of parity PARITY (the turn's count & 1).
// Packed-axis neighbours come by shuffle, the lines above and below the
// stack from the neighbouring stacks: by shuffle inside the warp, and at
// the warp's ends the neighbouring warps' edge line sums through shared
// memory: each warp puts its two edge sums, steps its inner lines, meets
// the block at its barrier, and takes its neighbours' sums. The sums are
// double-buffered by parity, so one barrier a turn keeps every read of a
// turn's sums before their slots are written again. An idle warp only
// meets the block.
template <int PARITY, int R, class Rule>
__device__ __forceinline__ void turn(uint32_t (&x)[R], const Stack& k, bool idle,
                                     const Rule& rule) {
    if (idle) {
        __syncthreads();
        return;
    }
    GolLineSum sum[R];
    // the first and last lines' sums first: they are what the neighbouring
    // warps take
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const int r = j == 0 ? 0 : (j == 1 ? R - 1 : j - 1);
        const uint32_t m = __shfl_sync(kFull, x[r], k.src_m);
        const uint32_t p = __shfl_sync(kFull, x[r], k.src_p);
        sum[r] = gol_line_sum(m, x[r], p);
    }
    const unsigned parity = PARITY * k.parity_bytes;
    put2(k.put_first + parity, sum[0]);
    put2(k.put_last + parity, sum[R - 1]);
    GolLineSum up, dn;
    up.v0 = __shfl_sync(kFull, sum[R - 1].v0, k.lane_up);
    up.v1 = __shfl_sync(kFull, sum[R - 1].v1, k.lane_up);
    dn.v0 = __shfl_sync(kFull, sum[0].v0, k.lane_dn);
    dn.v1 = __shfl_sync(kFull, sum[0].v1, k.lane_dn);
    uint32_t next[R];
#pragma unroll
    for (int r = 1; r + 1 < R; ++r) next[r] = gol_finish(rule, sum[r - 1], sum[r], sum[r + 1], x[r]);
    __syncthreads();
    const GolLineSum above = get2(k.get_up + parity);
    const GolLineSum below = get2(k.get_dn + parity);
    up.v0 = k.take_up ? above.v0 : up.v0;
    up.v1 = k.take_up ? above.v1 : up.v1;
    dn.v0 = k.take_dn ? below.v0 : dn.v0;
    dn.v1 = k.take_dn ? below.v1 : dn.v1;
    if constexpr (R == 1) {
        next[0] = gol_finish(rule, up, sum[0], dn, x[0]);
    } else {
        next[0] = gol_finish(rule, up, sum[0], sum[1], x[0]);
        next[R - 1] = gol_finish(rule, sum[R - 2], sum[R - 1], dn, x[R - 1]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = next[r];
}

// The meeting's primitives: `local` addresses are in this block's shared
// window, `remote` ones in the cluster's (mapa).
__device__ __forceinline__ unsigned cluster_address(unsigned local, int rank) {
    unsigned remote;
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
    return remote;
}

__device__ __forceinline__ void bar_init(unsigned bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// One word into another block's shared memory, counted as 4 bytes on its
// mbarrier at `remote_bar`; and four consecutive words at a 16-byte
// aligned address, counted as 16.
__device__ __forceinline__ void push(unsigned remote, uint32_t word, unsigned remote_bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                 ::"r"(remote), "r"(word), "r"(remote_bar)
                 : "memory");
}

__device__ __forceinline__ void push4(unsigned remote, uint32_t a, uint32_t b, uint32_t c,
                                      uint32_t d, unsigned remote_bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
        ::"r"(remote), "r"(a), "r"(b), "r"(c), "r"(d), "r"(remote_bar)
        : "memory");
}

// The block's one arrival on its own mbarrier for a meeting, expecting
// `bytes` of pushes (they may land before it: the phase cannot complete
// without the arrival).
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

}  // namespace regs

// A band of one board on a cluster of `cluster` blocks, the register loop
// (the header comment): n turns, the band written back, and unless
// row_counts is null the board's row popcounts. The block is whole warps,
// enough stacks of R lines to hold the slots.
template <int WORD_AXIS, int R, class Rule>
__global__ void __launch_bounds__(register_threads(R), 1)
whole_board_cluster_registers_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                     int32_t* __restrict__ row_counts, int rows, int cols,
                                     int n, int cluster, int depth, Rule rule) {
    extern __shared__ uint32_t smem[];
    const int P = WORD_AXIS == 0 ? rows : cols;  // words per line, <= 32
    const int Q = WORD_AXIS == 0 ? cols : rows;  // lines
    const int band = Q / cluster;
    cg::cluster_group group = cg::this_cluster();
    const int rank = static_cast<int>(group.block_rank());
    const int line0 = rank * band;
    const int slots = band + 2 * depth;
    const int warps = blockDim.x >> 5;
    // the meetings' two mbarriers (one a parity); for each parity the halo
    // slots the neighbours push into, the top `depth` lines then the
    // bottom, each packed index's lines side by side `pitch` words apart
    // (the depth in whole 16 bytes, an odd count of them: a thread's four
    // aligned lines go in one 16-byte push, and eight lanes' pushes to one
    // line fall in distinct banks); the slots, loaded at the start and
    // holding the band at the end; then, for each of two parities, the
    // warps' edge sums and the lanes' scratch slots
    const int pitch = halo_pitch(depth);
    const int halo_words = pitch * P;
    uint32_t* halos = smem + 4;
    uint32_t* copy = halos + 4 * halo_words;
    uint32_t* edges = copy + slots * P;
    const int stride = 4 * warps * P + 64;
    const unsigned bar = regs::shared_address(smem);
    if (threadIdx.x == 0) {
        regs::bar_init(bar);
        regs::bar_init(bar + 8);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    bands::load_slots<WORD_AXIS>(in, copy, cols, P, Q, line0, depth, slots);
    // every block's mbarriers are ready before any block pushes
    group.sync();

    const regs::Stack k = regs::make_stack(R, P, edges, stride);
    uint32_t x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int s = k.first + r;
        x[r] = k.live && s < slots ? copy[s * P + k.i] : 0u;
    }
    // the warps that hold halo slots wait for the pushes; the others go on
    const bool takes_halo = k.warp_first < depth || k.warp_last >= depth + band;

    int meeting = 0;
    int t = 0;
    bool arrived = false;  // the last meeting's pushes are in: a cluster barrier arrival
    for (int left = n; left > 0;) {
        // A phase of r <= depth turns: after turn s the slots from lo =
        // depth - r + s to slots - lo are right, so after the phase at least
        // the band is.
        const int r = min(depth, left);
        left -= r;
        for (int s = 1; s <= r; ++s, ++t) {
            // a warp whose lines all lie two slots or more outside those is
            // idle: nothing it holds is needed, nor its edge line by the
            // warp beside it
            const int lo = depth - r + s;
            const bool idle = k.warp_last <= lo - 2 || k.warp_first >= slots - lo + 1;
            if (t & 1) {
                regs::turn<1>(x, k, idle, rule);
            } else {
                regs::turn<0>(x, k, idle, rule);
            }
        }
        if (left > 0) {
            // The block meets its two neighbours (the header comment): its
            // band's first `depth` lines pushed into the bottom halo slots
            // of the block above, its last into the top halo slots of the
            // block below, those of the meeting's parity, each push counted
            // on that block's mbarrier of the parity; then its own halo
            // awaited and loaded. The remote addresses are made here, not
            // held through the turns.
            const int parity = meeting & 1;
            const int above = rank == 0 ? cluster - 1 : rank - 1;
            const int below = rank + 1 == cluster ? 0 : rank + 1;
            const unsigned mine =
                regs::shared_address(halos + 2 * halo_words * parity + k.i * pitch);
            const unsigned up_halo = regs::cluster_address(mine + 4 * halo_words, above);
            const unsigned dn_halo = regs::cluster_address(mine, below);
            const unsigned up_bar = regs::cluster_address(bar + 8 * parity, above);
            const unsigned dn_bar = regs::cluster_address(bar + 8 * parity, below);
            // by four lines where they lie whole and aligned in the halo
            // slots, else line by line
            constexpr int G = R < 4 ? 1 : 4;
#pragma unroll
            for (int g = 0; g < R; g += G) {
                const int s0 = k.first + g;
                bool up4 = false, dn4 = false;
                if constexpr (G == 4) {
                    up4 = (s0 - depth) % 4 == 0 && s0 >= depth && s0 + 4 <= 2 * depth;
                    dn4 = (s0 - band) % 4 == 0 && s0 >= band && s0 + 4 <= band + depth;
                    if (k.live && up4) {
                        regs::push4(up_halo + 4 * (s0 - depth), x[g], x[g + 1], x[g + 2], x[g + 3],
                                    up_bar);
                    }
                    if (k.live && dn4) {
                        regs::push4(dn_halo + 4 * (s0 - band), x[g], x[g + 1], x[g + 2], x[g + 3],
                                    dn_bar);
                    }
                }
#pragma unroll
                for (int j = g; j < g + G; ++j) {
                    const int slot = k.first + j;
                    if (k.live && !up4 && slot >= depth && slot < 2 * depth) {
                        regs::push(up_halo + 4 * (slot - depth), x[j], up_bar);
                    }
                    if (k.live && !dn4 && slot >= band && slot < band + depth) {
                        regs::push(dn_halo + 4 * (slot - band), x[j], dn_bar);
                    }
                }
            }
            if (threadIdx.x == 0) regs::bar_expect(bar + 8 * parity, 4 * 2 * depth * P);
            if (takes_halo) {
                // each mbarrier completes every other meeting
                regs::bar_wait(bar + 8 * parity, (meeting >> 1) & 1);
                const uint32_t* top = halos + 2 * halo_words * parity;
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    const int slot = k.first + j;
                    if (k.live && slot < depth) x[j] = top[k.i * pitch + slot];
                    if (k.live && slot >= depth + band && slot < slots) {
                        x[j] = top[halo_words + k.i * pitch + slot - depth - band];
                    }
                }
            }
            ++meeting;
            if (left <= depth) {
                // the last meeting: no block leaves before every push into
                // every block has landed (the wait below)
                asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
                arrived = true;
            }
        }
    }
    if (arrived) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    // the band into the slots, which no other block reads, and the edge
    // area for the row popcounts' parts
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const int slot = k.first + j;
        if (k.live && slot >= depth && slot < depth + band) copy[slot * P + k.i] = x[j];
    }
    __syncthreads();
    bands::store_band<WORD_AXIS>(copy + depth * P, reinterpret_cast<int32_t*>(edges), out,
                                 row_counts, cols, P, band, line0, rank, cluster, group);
}

// The SM count, resident threads and shared memory of an SM on the current
// device, read once per device.
cudaError_t sm_shape(int& sms, int& threads, int& smem) {
    static std::atomic<int> cached[kMaxDevices][3];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kMaxDevices) return cudaErrorInvalidDevice;
    const cudaDeviceAttr attrs[3] = {cudaDevAttrMultiProcessorCount,
                                     cudaDevAttrMaxThreadsPerMultiProcessor,
                                     cudaDevAttrMaxSharedMemoryPerMultiprocessor};
    int values[3];
    for (int a = 0; a < 3; ++a) {
        values[a] = cached[device][a].load(std::memory_order_relaxed);
        if (values[a] == 0) {
            err = cudaDeviceGetAttribute(&values[a], attrs[a], device);
            if (err != cudaSuccess) return err;
            cached[device][a].store(values[a], std::memory_order_relaxed);
        }
    }
    sms = values[0];
    threads = values[1];
    smem = values[2];
    return cudaSuccess;
}

struct Plan {
    int run_len, runs, threads;
};

// The block for `batch` boards of P x Q words: per_sm boards share an SM,
// so a block aims at a quarter of their share of its threads, and the runs
// are the shortest odd ones that keep the block within it.
Plan plan(int P, int Q, int batch, int sms, int sm_threads, int sm_smem, size_t smem) {
    const int by_smem = std::max(1, static_cast<int>(sm_smem / (smem + 1024)));  // + 1 KiB
    const int per_sm = std::min({(batch + sms - 1) / sms, by_smem, 32});         // reserved
    const int target = std::max(32, std::min(kMaxThreads, sm_threads / (4 * std::max(1, per_sm))));
    int run_len = 1;
    while (run_len < Q && P * ((Q + run_len - 1) / run_len) > target) run_len += 2;
    run_len = std::min(run_len, Q);
    const int runs = (Q + run_len - 1) / run_len;
    const int threads = std::min(kMaxThreads, (P * runs + 31) / 32 * 32);
    return {run_len, runs, threads};
}

template <int WORD_AXIS, bool HISTORY, class Rule>
int launch(const void* in, void* out, void* row_counts, void* turn_counts, int batch,
           int rows, int cols, int n, Rule rule, cudaStream_t stream) {
    static std::atomic<bool> opted[kMaxDevices];
    const size_t smem = 2 * static_cast<size_t>(rows) * cols * sizeof(uint32_t);
    int sms = 0, sm_threads = 0, sm_smem = 0;
    cudaError_t err = sm_shape(sms, sm_threads, sm_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int P = WORD_AXIS == 0 ? rows : cols;
    const int Q = WORD_AXIS == 0 ? cols : rows;
    const Plan p = plan(P, Q, batch, sms, sm_threads, sm_smem, smem);
    err = smem_opt_in_once(whole_board_kernel<WORD_AXIS, Rule, HISTORY>, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    whole_board_kernel<WORD_AXIS, Rule, HISTORY><<<batch, p.threads, smem, stream>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
        static_cast<int32_t*>(row_counts), static_cast<int32_t*>(turn_counts), rows, cols,
        n, p.run_len, p.runs, rule);
    return static_cast<int>(cudaGetLastError());
}

// A single board's route, as ops/whole_board.py::Route plans it: blocks
// (1: one block), and on a cluster its halo depth, its loop (lines a
// thread in the register loop, 0 the shared-memory loop) and the register
// loop's warps a block.
struct Route {
    int blocks, depth, lines, warps;
};

// Whether the compiled code runs `r` on a board of Q lines of P words. One
// block takes no depth, loop or warps. A cluster cuts the lines into bands
// of at least its depth, and runs the shared-memory loop (no warps) or the
// register loop at a compiled lines a thread, a line on one warp's lanes,
// with a block of warps that holds the band and its halo within the
// instantiation's __launch_bounds__.
bool runnable(const Route& r, int P, int Q) {
    if (r.blocks == 1) return r.depth == 0 && r.lines == 0 && r.warps == 0;
    if (r.blocks < 1 || Q % r.blocks != 0 || r.depth < 1 || r.depth > Q / r.blocks) return false;
    if (r.lines == 0) return r.warps == 0;
    if (r.lines != 2 && r.lines != 4 && r.lines != 8) return false;
    if (P < 1 || P > kRegMaxWords || r.warps < 1 || 32 * r.warps > register_threads(r.lines)) {
        return false;
    }
    return r.warps * (32 / P) * r.lines >= Q / r.blocks + 2 * r.depth;
}

// Launch `kernel` on one cluster of `cluster` blocks (16 is past the
// portable 8, which an H100 grants per kernel).
template <typename Kernel, typename... Args>
cudaError_t launch_on_cluster(Kernel* kernel, std::atomic<bool> (&opted)[kMaxDevices],
                              std::atomic<bool> (&wide)[kMaxDevices], int cluster, int threads,
                              size_t smem, cudaStream_t stream, Args... args) {
    cudaError_t err = smem_opt_in_once(kernel, opted);
    if (err != cudaSuccess) return err;
    if (cluster > 8) {
        int device = 0;
        err = cudaGetDevice(&device);
        if (err != cudaSuccess) return err;
        if (device >= kMaxDevices) return cudaErrorInvalidDevice;
        if (!wide[device].load(std::memory_order_acquire)) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != cudaSuccess) return err;
            wide[device].store(true, std::memory_order_release);
        }
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(cluster);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attribute[1];
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = cluster;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = 1;
    return cudaLaunchKernelEx(&config, kernel, args...);
}

// One launch of the cluster route's shared-memory loop: `cluster` blocks,
// `depth` halo lines (clamped by the caller). Returns the launch's error; a
// cluster the card cannot schedule is refused here.
template <int WORD_AXIS, class Rule>
cudaError_t launch_cluster(const void* in, void* out, void* row_counts, int rows, int cols,
                           int n, int cluster, int depth, Rule rule, cudaStream_t stream) {
    static std::atomic<bool> opted[kMaxDevices];
    static std::atomic<bool> wide[kMaxDevices];
    const int P = WORD_AXIS == 0 ? rows : cols;
    const int Q = WORD_AXIS == 0 ? cols : rows;
    const int slots = Q / cluster + 2 * depth;
    // the shortest odd runs that keep the block near kClusterThreadAim threads
    int run_len = 1;
    while (run_len < slots && P * ((slots + run_len - 1) / run_len) > kClusterThreadAim) {
        run_len += 2;
    }
    const int runs = (slots + run_len - 1) / run_len;
    const long long items = static_cast<long long>(P) * runs;
    const int threads =
        items >= kMaxThreads ? kMaxThreads : static_cast<int>((items + 31) / 32 * 32);
    const size_t smem = 2 * static_cast<size_t>(slots) * P * sizeof(uint32_t);
    return launch_on_cluster(whole_board_cluster_kernel<WORD_AXIS, Rule>, opted, wide, cluster,
                             threads, smem, stream, static_cast<const uint32_t*>(in),
                             static_cast<uint32_t*>(out), static_cast<int32_t*>(row_counts),
                             rows, cols, n, cluster, depth, run_len, runs, rule);
}

// One launch of the register loop with R lines a thread; as
// launch_cluster.
template <int WORD_AXIS, int R, class Rule>
cudaError_t launch_cluster_registers(const void* in, void* out, void* row_counts, int rows,
                                     int cols, int n, int cluster, int depth, int warps,
                                     Rule rule, cudaStream_t stream) {
    static std::atomic<bool> opted[kMaxDevices];
    static std::atomic<bool> wide[kMaxDevices];
    const int P = WORD_AXIS == 0 ? rows : cols;
    const int Q = WORD_AXIS == 0 ? cols : rows;
    const int slots = Q / cluster + 2 * depth;
    // two mbarriers (4 words); the halo slots of two parities; the slots;
    // for each of two parities the warps' edge sums (two words, two sides)
    // and the lanes' scratch slots
    const size_t smem = (4 + 4 * static_cast<size_t>(halo_pitch(depth)) * P +
                         static_cast<size_t>(slots) * P +
                         2 * (4 * warps * P + 64)) *
                        sizeof(uint32_t);
    return launch_on_cluster(whole_board_cluster_registers_kernel<WORD_AXIS, R, Rule>, opted,
                             wide, cluster, 32 * warps, smem, stream,
                             static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
                             static_cast<int32_t*>(row_counts), rows, cols, n, cluster, depth,
                             rule);
}

// The route's cluster launch, either loop (route.lines 0, 2, 4 or 8;
// runnable has refused any other).
template <int WORD_AXIS, class Rule>
cudaError_t launch_route(const void* in, void* out, void* row_counts, int rows, int cols, int n,
                         const Route& route, Rule rule, cudaStream_t stream) {
    const int c = route.blocks, d = route.depth, w = route.warps;
    switch (route.lines) {
        case 0:
            return launch_cluster<WORD_AXIS>(in, out, row_counts, rows, cols, n, c, d, rule,
                                             stream);
        case 2:
            return launch_cluster_registers<WORD_AXIS, 2>(in, out, row_counts, rows, cols, n, c,
                                                          d, w, rule, stream);
        case 4:
            return launch_cluster_registers<WORD_AXIS, 4>(in, out, row_counts, rows, cols, n, c,
                                                          d, w, rule, stream);
        default:
            return launch_cluster_registers<WORD_AXIS, 8>(in, out, row_counts, rows, cols, n, c,
                                                          d, w, rule, stream);
    }
}

}  // namespace

extern "C" {

// The block's opt-in shared memory limit on `device`, the K1 gate's input.
int gol_max_smem_optin(int device, int* bytes) {
    return static_cast<int>(
        cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// n turns of each of the `batch` boards of `in` (int32[batch, rows, cols])
// into `out`, and, unless row_counts is null, the popcount of each of the
// results' rows into int32[batch, rows]. The (common, dead_only, live_only)
// masks pick a compiled rule or the run-time one. Returns cudaGetLastError()
// after the launch (0 on success).
int gol_whole_board_step(const void* in, void* out, void* row_counts, int batch, int rows,
                         int cols, int word_axis, int n, unsigned common, unsigned dead_only,
                         unsigned live_only, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return gol_with_rule(common, dead_only, live_only, [&](auto rule) {
        if (word_axis == 0) {
            return launch<0, false>(in, out, row_counts, nullptr, batch, rows, cols, n, rule, s);
        }
        return launch<1, false>(in, out, row_counts, nullptr, batch, rows, cols, n, rule, s);
    });
}

// n turns of one board, `in` (int32[rows, cols]), into `out`, with its row
// popcounts into int32[rows] unless row_counts is null, on the route
// int route[4] holds (Route: blocks, depth, lines, warps; 0 for what a
// route does not use). A cluster launch the card refuses runs on one block
// instead, and route then holds {1, 0, 0, 0}. Returns the launch's CUDA
// error (0 on success); cudaErrorInvalidValue for a route the compiled code
// cannot run (runnable).
int gol_whole_board_step_as(const void* in, void* out, void* row_counts, int rows, int cols,
                            int word_axis, int n, unsigned common, unsigned dead_only,
                            unsigned live_only, int* route, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Route r = {route[0], route[1], route[2], route[3]};
    if (!runnable(r, word_axis == 0 ? rows : cols, word_axis == 0 ? cols : rows)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return gol_with_rule(common, dead_only, live_only, [&](auto rule) {
        if (r.blocks > 1) {
            const cudaError_t err =
                word_axis == 0 ? launch_route<0>(in, out, row_counts, rows, cols, n, r, rule, s)
                               : launch_route<1>(in, out, row_counts, rows, cols, n, r, rule, s);
            if (err == cudaSuccess) return static_cast<int>(cudaGetLastError());
            cudaGetLastError();  // the refusal is not left pending: one block runs instead
            route[0] = 1;
            route[1] = route[2] = route[3] = 0;
        }
        if (word_axis == 0) {
            return launch<0, false>(in, out, row_counts, nullptr, 1, rows, cols, n, rule, s);
        }
        return launch<1, false>(in, out, row_counts, nullptr, 1, rows, cols, n, rule, s);
    });
}

// The history mode: n turns of each of the `batch` boards of `in` into
// `out`, and each board's alive count after every turn 1..n into
// int32[batch, n] `turn_counts`. Returns as gol_whole_board_step.
int gol_whole_board_history(const void* in, void* out, void* turn_counts, int batch,
                            int rows, int cols, int word_axis, int n, unsigned common,
                            unsigned dead_only, unsigned live_only, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return gol_with_rule(common, dead_only, live_only, [&](auto rule) {
        if (word_axis == 0) {
            return launch<0, true>(in, out, nullptr, turn_counts, batch, rows, cols, n, rule, s);
        }
        return launch<1, true>(in, out, nullptr, turn_counts, batch, rows, cols, n, rule, s);
    });
}

}  // extern "C"
