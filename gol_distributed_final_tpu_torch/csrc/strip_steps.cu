// The resident worker's strip batch: k <= 32 Conway turns per launch of a
// padded uint8 {0, 255} strip in shrinking form, with the strip's alive
// count after every turn and, on request, every turn's attestation bands.
//
// Replaces the XLA program of the JAX package's fused_strip_steps,
// gol_distributed_final_tpu/ops/fused.py:673 (its turn, _jax_strip_turn,
// at :640), the batch a resident worker runs under StripStep
// (gol_distributed_final_tpu/rpc/worker.py:271).
//
// The function. A batch of K turns starts from the block [top K rows; the
// strip's h rows; bottom K rows], L = h + 2K lines of w cells. Columns wrap
// within the block's width; lines do not: each turn consumes one line at
// each end, so after K turns the block is the strip, K turns later. After
// turn i (1-based) the strip's rows are lines [K, K + h) of the first block
// still, and the two bands the neighbouring workers compute as well are
// lines [i, 2K - i) and [h + i, h + 2K - i): 2 (K - i) lines each.
//
// A launch takes k <= 32 of the batch's turns: the block it reads has R
// turns of halo left (R = K - turns before it, so L = h + 2R lines), and it
// writes the block k turns on, L - 2k lines. In the launch's own frame,
// turn t (1-based) leaves lines [t, L - t) valid, the strip at [R, R + h),
// the bands at [t, 2R - t) and [h + t, h + 2R - t).
//
// Design, on the byte-tile kernel's core (byte_tiled.cu): block (bx, by)
// owns lines [by * kRows, (by + 1) * kRows) of the launch's block and
// 32 * kWords columns; its window adds k lines above and below and one word
// on each side.
// - Gather and pack as byte_tiled.cu does, with one difference: lines come
//   from the block as given and never wrap. A window line outside the block
//   packs to zero; no line whose value is read depends on one (a line the
//   launch keeps at turn t is at least t lines inside the block). Columns
//   wrap in cells, modulo w, before packing, so no width need divide by 32.
// - Step k turns with bit_step.cuh's walk, the rule Conway at compile time,
//   two copies ping-ponged, one barrier a turn; the window's lines shrink
//   by one a side a turn, and one halo word covers k <= 32 (byte_tiled.cu).
// - After each turn, while the next one runs on the other copy, the block
//   popcounts the strip lines it owns into a per-turn sum in shared memory,
//   and writes the band lines it owns as {0, 255} bytes to the batch's flat
//   band output, every turn's top band then its bottom band in turn order.
//   After the last turn one atomic add per turn and block carries the sums
//   into counts (int32 on the card).
// - Unpack the lines it owns of the launch's result block.
//
// What bounds it. A launch reads L * w bytes and writes (L - 2k) * w, plus
// the bands; the turns cost 12 int32 instructions per 32 cells. At k = 8
// that is about 5 instructions per cell, so device memory binds.
#include <cuda_runtime.h>

#include <cstdint>

#include "bit_step.cuh"
#include "byte_pack.cuh"

namespace {

constexpr int kMaxTurns = 32;
constexpr int kMaxGridY = 65535;
constexpr int kMinBlocks = 132;  // fewer wide tiles than this: the small tile
using Conway = StaticRule<8u, 0u, 16u>;

template <int ROWS, int COLS, int THREADS>
struct Tile {
    static_assert(COLS % 32 == 0, "a tile is whole words wide");
    static constexpr int kRows = ROWS;
    static constexpr int kCols = COLS;
    static constexpr int kWords = COLS / 32;
    static constexpr int kP = kWords + 2;  // the window's words per line
    static constexpr int kThreads = THREADS;
};
// the byte-tile kernel's two tiles (ops/strip_steps.py::TILE, SMALL_TILE)
using WideTile = Tile<64, 256, 256>;
using SmallTile = Tile<16, 64, 128>;

__device__ __forceinline__ int wrap(int i, int n) {
    if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
    const int m = i % n;
    return m < 0 ? m + n : m;
}

struct Args {
    const uint8_t* in;  // the launch's block, lines x cols
    uint8_t* out;       // the block k turns on, (lines - 2k) x cols
    int lines, cols, k, h;
    int batch_k;        // K: the batch's turns
    int done;           // the batch's turns before this launch
    int* counts;        // K per-turn strip counts, zeroed before the batch
    uint8_t* bands;     // the batch's flat band output, or null
    int run_len, runs;
    int wide;           // cols % 16 == 0 and every buffer 16-byte aligned
};

// byte offset of turn i's (0-based over the batch) top band in the flat
// band output: each earlier turn j wrote 2 bands of 2 (K - 1 - j) lines
__device__ __forceinline__ size_t band_base(int i, int batch_k, int cols) {
    const long long lines = 4LL * i * (batch_k - 1) - 2LL * i * (i - 1);
    return static_cast<size_t>(lines) * cols;
}

__device__ __forceinline__ void store_word(uint32_t word, uint8_t* dst, int gc, int cols,
                                           int wide) {
    if (wide && gc + 32 <= cols) {
        gol_unpack32_wide(word, dst);
    } else {
        gol_unpack_bytes(word, dst, min(32, cols - gc));
    }
}

template <class T>
__global__ void __launch_bounds__(T::kThreads) strip_steps_kernel(Args a) {
    extern __shared__ uint32_t smem[];
    __shared__ int turn_count[kMaxTurns];
    const int k = a.k;
    const int wl = T::kRows + 2 * k;  // window lines
    uint32_t* cur = smem;
    uint32_t* nxt = smem + wl * T::kP;
    const int r0 = blockIdx.y * T::kRows;  // first owned line of the block
    const int c0 = blockIdx.x * T::kCols;
    const int halo = a.batch_k - a.done;   // R: the launch's halo lines a side

    if (threadIdx.x < kMaxTurns) turn_count[threadIdx.x] = 0;
    for (int e = threadIdx.x; e < wl * T::kP; e += T::kThreads) {
        const int line = e / T::kP;
        const int w = e - line * T::kP;
        const int gr = r0 - k + line;
        if (gr < 0 || gr >= a.lines) {
            cur[e] = 0;
            continue;
        }
        const uint8_t* row = a.in + static_cast<size_t>(gr) * a.cols;
        const int gc = wrap(c0 + 32 * (w - 1), a.cols);
        cur[e] = (a.wide && gc + 32 <= a.cols) ? gol_pack32_wide(row + gc)
                                               : gol_pack32_wrapped(row, gc, a.cols);
    }

    const int tid = threadIdx.x;
    const int r = tid / T::kP;
    const int i = tid - r * T::kP;
    const int j0 = r * a.run_len;
    const bool active = r < a.runs;
    const int m = i == 0 ? 0 : i - 1;
    const int p = i + 1 == T::kP ? i : i + 1;
    // the owned lines that are on the block and the owned words on the board
    const int own_hi = min(r0 + T::kRows, a.lines);
    const int own_words = min(T::kWords, (a.cols - c0 + 31) / 32);
    const int lane = threadIdx.x & 31;
    __syncthreads();

    for (int t = 1; t <= k; ++t) {
        const int js = max(j0, t);
        const int je = min(j0 + a.run_len, wl - t);
        if (active && js < je) {
            gol_walk(cur + m, cur + i, cur + p, nxt + i, (js - 1) * T::kP, js * T::kP, T::kP,
                     je - js, je * T::kP, Conway{});
        }
        __syncthreads();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;

        // the strip's count after turn t: its owned lines, its owned words
        // masked to the board's width
        const int s_lo = max(r0, halo);
        const int s_hi = min(own_hi, halo + a.h);
        int sum = 0;
        for (int e = threadIdx.x; e < (s_hi - s_lo) * own_words; e += T::kThreads) {
            const int lr = e / own_words;
            const int tw = e - lr * own_words;
            const int bits = min(32, a.cols - (c0 + 32 * tw));
            const uint32_t mask = bits == 32 ? ~0u : (1u << bits) - 1u;
            sum += __popc(cur[(k + s_lo + lr - r0) * T::kP + 1 + tw] & mask);
        }
        sum = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(sum)));
        if (lane == 0 && sum) atomicAdd(&turn_count[t - 1], sum);

        if (a.bands != nullptr) {
            const int turn = a.done + t - 1;  // over the batch, 0-based
            const int band = 2 * (halo - t);  // lines in each band
            const size_t base = band_base(turn, a.batch_k, a.cols);
            for (int side = 0; side < 2; ++side) {
                const int b_lo = side == 0 ? t : a.h + t;  // the band's first line
                const int lo = max(r0, b_lo);
                const int hi = min(own_hi, b_lo + band);
                uint8_t* out = a.bands + base + static_cast<size_t>(side) * band * a.cols;
                for (int e = threadIdx.x; e < (hi - lo) * own_words; e += T::kThreads) {
                    const int lr = e / own_words;
                    const int tw = e - lr * own_words;
                    const int gc = c0 + 32 * tw;
                    const uint32_t word = cur[(k + lo + lr - r0) * T::kP + 1 + tw];
                    store_word(word, out + static_cast<size_t>(lo + lr - b_lo) * a.cols + gc,
                               gc, a.cols, a.wide);
                }
            }
        }
    }
    __syncthreads();
    if (threadIdx.x < k && turn_count[threadIdx.x]) {
        atomicAdd(&a.counts[a.done + threadIdx.x], turn_count[threadIdx.x]);
    }

    // the result block: lines [k, lines - k) of this launch's block
    const int o_lo = max(r0, k);
    const int o_hi = min(own_hi, a.lines - k);
    for (int e = threadIdx.x; e < (o_hi - o_lo) * own_words; e += T::kThreads) {
        const int lr = e / own_words;
        const int tw = e - lr * own_words;
        const int gc = c0 + 32 * tw;
        const uint32_t word = cur[(k + o_lo + lr - r0) * T::kP + 1 + tw];
        store_word(word, a.out + static_cast<size_t>(o_lo + lr - k) * a.cols + gc, gc, a.cols,
                   a.wide);
    }
}

template <class T>
int launch(Args a, cudaStream_t stream) {
    const int grid_y = (a.lines + T::kRows - 1) / T::kRows;
    if (grid_y > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
    const int wl = T::kRows + 2 * a.k;
    const int runs_max = T::kThreads / T::kP;
    a.run_len = ((wl + runs_max - 1) / runs_max) | 1;
    a.runs = (wl + a.run_len - 1) / a.run_len;
    const dim3 grid((a.cols + T::kCols - 1) / T::kCols, grid_y);
    const size_t smem = 2 * static_cast<size_t>(wl) * T::kP * sizeof(uint32_t);
    strip_steps_kernel<T><<<grid, T::kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

static_assert(2 * (64 + 2 * kMaxTurns) * (256 / 32 + 2) * 4 <= 48 * 1024, "window");

inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// k turns (1..32) of a strip batch of `batch_k` turns, of which `done` ran
// before this launch: `in` is the block of lines = h + 2 * (batch_k - done)
// uint8 lines of `cols` cells, `out` receives lines - 2k lines (the strip,
// when done + k == batch_k), and must not alias `in`. Turn i's (0-based)
// strip count is added to counts[i], which the caller zeroed before the
// batch; `bands`, when not null, receives every turn's top and bottom band
// in the flat layout of ops/strip_steps.py::band_offsets. `tile`: 0 by the
// block's size, 1 the wide tile, 2 the small one. Returns
// cudaGetLastError() after the launch (0 on success); cudaErrorInvalidValue
// for arguments outside these ranges or more tile rows than a grid holds.
int gol_strip_steps(const void* in, void* out, int lines, int cols, int k, int h, int batch_k,
                    int done, int* counts, void* bands, int tile, void* stream) {
    if (k < 1 || k > kMaxTurns || h < 1 || cols < 1 || done < 0 || done + k > batch_k ||
        lines != h + 2 * (batch_k - done) || counts == nullptr || tile < 0 || tile > 2) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Args a{};
    a.in = static_cast<const uint8_t*>(in);
    a.out = static_cast<uint8_t*>(out);
    a.lines = lines;
    a.cols = cols;
    a.k = k;
    a.h = h;
    a.batch_k = batch_k;
    a.done = done;
    a.counts = counts;
    a.bands = static_cast<uint8_t*>(bands);
    a.wide = cols % 16 == 0 && aligned16(in) && aligned16(out) &&
             (bands == nullptr || aligned16(bands));
    if (tile == 0) {
        const long long wide_blocks = static_cast<long long>((lines + WideTile::kRows - 1) /
                                                             WideTile::kRows) *
                                      ((cols + WideTile::kCols - 1) / WideTile::kCols);
        tile = wide_blocks < kMinBlocks ? 2 : 1;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return tile == 1 ? launch<WideTile>(a, s) : launch<SmallTile>(a, s);
}

}  // extern "C"
