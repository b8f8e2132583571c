// The tiled bitboard kernel: k <= 8 turns of any B/S rule per launch on a
// packed board of any size, cut into 2-D tiles.
//
// Replaces both tiled Pallas kernels of the JAX package,
// gol_distributed_final_tpu/ops/pallas_tiled.py:284 (tiled_pallas_call):
// K3, the "rows" mode (:335, body _tiled_kernel_rows at :204), and K4, the
// "grid2d" mode (:349, body _tiled_kernel_2d at :242). One 2-D grid serves
// both: a full-width row block is just a row of tiles across the board.
//
// What bounds it. Each launch reads and writes the board once and the
// function needs 12 int32 instructions per word per turn for Conway
// (ops/bitpack.py::ops_per_word), so at K = 8 the integer rate binds, not
// device memory. What the kernel spends beyond that: the halo it steps, and
// the loads, stores and loop of bit_step.cuh's walk.
//
// Design. Block (bx, by) owns the output tile of kTileR x kTileC words at
// (by * kTileR, bx * kTileC). It loads that tile and its halo into shared
// memory, the torus coming from index arithmetic modulo the board (the
// index maps of pallas_tiled.py:316-326 do the same in block units), runs K
// turns there, two window copies ping-ponged, and writes the tile out.
// Blocks run in no order, so the output goes to a second board; n turns
// take ceil(n / K) launches, ping-ponged by the wrapper (ops/tiled.py).
//
// The halo differs by axis. A turn moves one cell, so across the lines (the
// axis that is not packed) it takes K words and shrinks: after turn t only
// the lines at least t from the window's edge are valid, and turn t steps
// just those (the cone of pallas_tiled.py:222-226). Along the packed axis a
// word is 32 cells, so one halo word on each side covers K <= 8 < 32 turns:
// those words are stepped every turn, their missing outer neighbour taken
// as the word itself, which spoils one more of their outer bits a turn and
// never reaches the tile. At K = 8 the window is 34 x 144 words (word axis
// 0) or 48 x 130 (word axis 1), 1.12x and 1.24x the tile's work over K turns,
// where a K-word halo on every side took 1.29x.
//
// Each thread owns one run of consecutive lines at one packed index of the
// window (bit_step.cuh's walk: 3 loads and one packed-axis sum per word),
// set before the turn loop; turn t clips it to the cone. The tile, K, the
// runs and the window are compile-time constants (one instantiation per K in
// 1..8, packing and rule), so no index is divided at run time. For word axis
// 0 the window's row stride is padded to runs x run length with an odd run
// length, so lane l reads word L * l + s at step s and the 32 lanes of a warp
// hit 32 banks; for word axis 1 lanes take neighbouring packed indices.
// ops/tiled.py::TILE says why the tile is 32 x 128 words.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "bit_step.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int kMaxTurns = 8;
constexpr int kTileR = 32;   // output tile rows, in words (ops/tiled.py::TILE)
constexpr int kTileC = 128;  // output tile cols, in words
constexpr int kThreadAim = 256;  // runs per block, about

constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The window of one block for a packing and K turns.
template <int WORD_AXIS, int K>
struct Window {
    // P packed indices (the tile's and one halo word each side) by Q lines
    // (the tile's and K halo lines each side)
    static constexpr int kP = (WORD_AXIS == 0 ? kTileR : kTileC) + 2;
    static constexpr int kQ = (WORD_AXIS == 0 ? kTileC : kTileR) + 2 * K;
    // runs per packed index, and their odd length
    static constexpr int kLen = ceil_div(kQ, ceil_div(kThreadAim, kP)) | 1;
    static constexpr int kRuns = ceil_div(kQ, kLen);
    static constexpr int kItems = kP * kRuns;
    static constexpr int kThreads = ceil_div(kItems, 32) * 32;
    // the window in the board's layout, and its halo
    static constexpr int kRows = WORD_AXIS == 0 ? kP : kQ;
    static constexpr int kCols = WORD_AXIS == 0 ? kQ : kP;
    static constexpr int kHaloR = WORD_AXIS == 0 ? 1 : K;
    static constexpr int kHaloC = WORD_AXIS == 0 ? K : 1;
    static constexpr int kStride = WORD_AXIS == 0 ? kRuns * kLen : kP;  // row stride
    static constexpr int kPStride = WORD_AXIS == 0 ? kStride : 1;
    static constexpr int kOStride = WORD_AXIS == 0 ? 1 : kStride;
    static constexpr int kWords = kRows * kStride;
    static constexpr size_t kSmem = 2 * static_cast<size_t>(kWords) * sizeof(uint32_t);
    static_assert(kRuns * kLen >= kQ && kThreads <= 1024, "window plan");
};

// i modulo n for any int i and n > 0: the fast path takes the indices that
// are already on the board
__device__ __forceinline__ int wrap(int i, int n) {
    if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
    const int m = i % n;
    return m < 0 ? m + n : m;
}

template <int WORD_AXIS, int K, class Rule>
__global__ void __launch_bounds__(Window<WORD_AXIS, K>::kThreads)
tiled_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int rows,
             int cols, Rule rule) {
    using W = Window<WORD_AXIS, K>;
    extern __shared__ uint32_t smem[];
    uint32_t* cur = smem;
    uint32_t* nxt = smem + W::kWords;
    const int r0 = blockIdx.y * kTileR;
    const int c0 = blockIdx.x * kTileC;

    for (int e = threadIdx.x; e < W::kRows * W::kCols; e += W::kThreads) {
        const int wr = e / W::kCols;
        const int wc = e - wr * W::kCols;
        const size_t gr = wrap(r0 - W::kHaloR + wr, rows);
        const size_t gc = wrap(c0 - W::kHaloC + wc, cols);
        cur[wr * W::kStride + wc] = in[gr * cols + gc];
    }

    // this thread's run: lines [j0, j0 + kLen) at packed index i; neighbouring
    // lanes take neighbouring words of a window row
    const int tid = threadIdx.x;
    int i, j0;
    if (WORD_AXIS == 0) {
        i = tid / W::kRuns;
        j0 = (tid - i * W::kRuns) * W::kLen;
    } else {
        const int r = tid / W::kP;
        i = tid - r * W::kP;
        j0 = r * W::kLen;
    }
    const bool active = tid < W::kItems;
    const int m = (i == 0 ? 0 : i - 1) * W::kPStride;  // the halo words' outer
    const int c = i * W::kPStride;                      // neighbour is the word
    const int p = (i + 1 == W::kP ? i : i + 1) * W::kPStride;  // itself
    __syncthreads();

#pragma unroll
    for (int t = 1; t <= K; ++t) {
        // the cone: turn t steps lines t .. kQ - t - 1
        const int js = max(j0, t);
        const int je = min(j0 + W::kLen, W::kQ - t);
        if (active && js < je) {
            gol_walk(cur + m, cur + c, cur + p, nxt + c, (js - 1) * W::kOStride,
                     js * W::kOStride, W::kOStride, je - js, je * W::kOStride, rule);
        }
        __syncthreads();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    for (int e = threadIdx.x; e < kTileR * kTileC; e += W::kThreads) {
        const int tr = e / kTileC;
        const int tc = e - tr * kTileC;
        const int gr = r0 + tr;
        const int gc = c0 + tc;
        if (gr < rows && gc < cols) {
            out[static_cast<size_t>(gr) * cols + gc] =
                cur[(W::kHaloR + tr) * W::kStride + W::kHaloC + tc];
        }
    }
}

template <int WORD_AXIS, int K, class Rule>
int launch(const void* in, void* out, int rows, int cols, Rule rule, cudaStream_t stream) {
    using W = Window<WORD_AXIS, K>;
    static std::atomic<bool> opted[kMaxDevices];
    const cudaError_t err = smem_opt_in_once(tiled_kernel<WORD_AXIS, K, Rule>, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((cols + kTileC - 1) / kTileC, (rows + kTileR - 1) / kTileR);
    tiled_kernel<WORD_AXIS, K, Rule><<<grid, W::kThreads, W::kSmem, stream>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows, cols, rule);
    return static_cast<int>(cudaGetLastError());
}

template <int WORD_AXIS, class Rule>
int launch_k(const void* in, void* out, int rows, int cols, int k, Rule rule,
             cudaStream_t stream) {
    switch (k) {
        case 1: return launch<WORD_AXIS, 1>(in, out, rows, cols, rule, stream);
        case 2: return launch<WORD_AXIS, 2>(in, out, rows, cols, rule, stream);
        case 3: return launch<WORD_AXIS, 3>(in, out, rows, cols, rule, stream);
        case 4: return launch<WORD_AXIS, 4>(in, out, rows, cols, rule, stream);
        case 5: return launch<WORD_AXIS, 5>(in, out, rows, cols, rule, stream);
        case 6: return launch<WORD_AXIS, 6>(in, out, rows, cols, rule, stream);
        case 7: return launch<WORD_AXIS, 7>(in, out, rows, cols, rule, stream);
        case 8: return launch<WORD_AXIS, 8>(in, out, rows, cols, rule, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

static_assert(kMaxTurns == 8, "launch_k instantiates K = 1..8");
static_assert(kMaxTurns < 32, "one halo word covers fewer than 32 turns");

}  // namespace

extern "C" {

// k turns (1..8) of `in` (int32[rows, cols]) into `out`, which must not
// alias `in`. The (common, dead_only, live_only) masks pick a compiled rule
// or the run-time one. Returns cudaGetLastError() after the launch (0 on
// success); cudaErrorInvalidValue for a k outside 1..8.
int gol_tiled_step(const void* in, void* out, int rows, int cols, int word_axis, int k,
                   unsigned common, unsigned dead_only, unsigned live_only, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return gol_with_rule(common, dead_only, live_only, [&](auto rule) {
        if (word_axis == 0) return launch_k<0>(in, out, rows, cols, k, rule, s);
        return launch_k<1>(in, out, rows, cols, k, rule, s);
    });
}

}  // extern "C"
