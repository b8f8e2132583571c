// The resident worker's strip batch: k <= 32 Conway turns per launch of a
// uint8 {0, 255} strip block in shrinking form, with the strip's alive count
// after every turn, on request every turn's attestation bands, and on the
// batch's launches the epilogue a resident worker needs: the wire-tile dirty
// grid of the batch and the adler32 sums of the strip before and after it.
//
// Replaces the XLA program of the JAX package's fused_strip_steps,
// gol_distributed_final_tpu/ops/fused.py:673 (its turn, _jax_strip_turn,
// at :640), the batch a resident worker runs under StripStep
// (gol_distributed_final_tpu/rpc/worker.py:729), and the host passes that
// StripStep makes around it: dirty_tile_grid (ops/sparse.py:518) and the
// state_digest of the strip before and after the batch (rpc/integrity.py:156).
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
// the bands at [t, 2R - t) and [h + t, h + 2R - t). The block comes as three
// pointers, R top lines, the strip's h and R bottom lines, so a worker's
// resident strip and its halos are read where they lie, never joined.
//
// The epilogue. On the batch's last launch the output is the new strip, and
// each tile of it is one wire tile (ops/sparse.py::WIRE_TILE_ROWS x
// WIRE_TILE_COLS, 64 x 256) or nests inside one: a tile that differs in any
// byte from the strip before the batch stores one flag into the zeroed
// grid. The strip before the batch is the first launch's middle lines, so
// with K <= 32 the compare reads the bytes the tile gathered; a chained
// batch's last launch reads them again from the caller's resident buffer.
// Every byte is compared, so a strip holding bytes outside {0, 255} is
// dirty wherever the kernel's {0, 255} output differs. The adler32 sums of
// a strip of n bytes d_p (row-major position p) are S1 = sum d_p and
// S2 = sum (n - p) d_p: the first launch takes the old strip's from the raw
// bytes it gathers (dp4a), the last launch the new strip's from the words
// it stores (popcounts by bit position). A CTA reduces each modulo 65521 and
// adds it to a 64-bit sum with one integer atomic, so the result does not
// depend on the order of CTAs; rpc/integrity.py::state_add_sums folds them
// into digests equal to zlib.adler32 of the bytes.
//
// Design for the H100. Tiles of the launch's output, each with a window of
// its lines, k lines above and below, and one word (32 cells) on each side.
// Persistent CTAs: the grid is as many CTAs as the occupancy API lets the
// SMs hold at this k, at most one a tile, and each CTA walks tiles
// blockIdx.x, + gridDim.x, ...; so no tail wave, and per-CTA sums and counts
// reach device memory once per CTA, not once per tile.
// - Gather. Where every row is 16-byte aligned (w a multiple of 16), the
//   window's raw bytes come in 16-byte cp.async copies into one of two
//   staging buffers, columns wrapped modulo w per copy; the next tile's
//   copies are issued before this tile steps, so its load latency hides
//   behind the k turns. Other widths gather synchronously byte by byte with
//   the wrap per cell (any width). Lines past the block pack to zero; no
//   line whose value is kept depends on one.
// - Pack the staged bytes into bits (byte_pack.cuh), and on the first
//   launch sum the strip bytes the tile owns.
// - Step k turns with bit_step.cuh's walk, the rule Conway at compile time,
//   two copies ping-ponged, one barrier a turn; the window's lines shrink
//   by one a side a turn, and one halo word covers k <= 32 (byte_tiled.cu).
//   After each turn the CTA popcounts the strip lines it owns into a
//   per-turn sum in shared memory and writes its band lines as {0, 255}
//   bytes to the batch's flat band output, every turn's top band then its
//   bottom band in turn order.
// - Unpack the tile's output lines; on the last launch sum them, compare
//   them with the old strip, and copy the strip's first and last K rows to
//   the reply's edges.
// The tiles own the launch's lines as a partition: tile row y owns output
// lines [64 y, 64 y + 64), which are input lines [64 y + k, 64 y + 64 + k);
// the first row also owns input lines [0, k) and the last those past its
// own, so every band line, strip line and strip byte has one owner.
//
// What bounds it. A launch reads L * w bytes and writes (L - 2k) * w, plus
// the bands; the epilogue adds the grid and four sums, and a chained
// batch's last launch reads the old strip again (h * w). The turns cost 12
// int32 instructions per 32 cells. At k = 8 that is about 5 instructions
// per cell, so device memory binds the bound. Measured on an H100
// (PERF.md), a worker's 1024 x 4096 strip is 256 tiles, which the
// grid holds at once, and the launch is latency-bound at ~1.45 us a turn;
// grids capped below the tile count, so that CTAs walk tiles, are slower.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "bit_step.cuh"
#include "byte_pack.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int kMaxTurns = 32;
constexpr unsigned kMod = 65521;  // adler32's modulus
constexpr int kWireRows = 64;     // ops/sparse.py::WIRE_TILE_ROWS, WIRE_TILE_COLS
constexpr int kWireCols = 256;
constexpr int kCounters = kMaxTurns + 4;  // shared words: per-turn counts, sums' partials
static_assert(kCounters % 4 == 0, "the staging buffers stay 16-byte aligned");
using Conway = StaticRule<8u, 0u, 16u>;

template <int ROWS, int COLS, int THREADS>
struct Tile {
    static_assert(COLS % 32 == 0, "a tile is whole words wide");
    static_assert(kWireRows % ROWS == 0 && kWireCols % COLS == 0, "a tile nests in a wire tile");
    static constexpr int kRows = ROWS;
    static constexpr int kCols = COLS;
    static constexpr int kWords = COLS / 32;
    static constexpr int kP = kWords + 2;        // the window's words per line
    static constexpr int kLineBytes = 32 * kP;   // a staged window line
    static constexpr int kChunks = kLineBytes / 16;
    static constexpr int kThreads = THREADS;
};
// the byte-tile kernel's two tiles (ops/byte_tiled.py::TILE, SMALL_TILE)
using WideTile = Tile<64, 256, 256>;
using SmallTile = Tile<16, 64, 128>;

__device__ __forceinline__ int wrap(int i, int n) {
    if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
    const int m = i % n;
    return m < 0 ? m + n : m;
}

struct Args {
    const uint8_t* top;  // the launch's block: `halo` lines,
    const uint8_t* mid;  // the strip's h lines,
    const uint8_t* bot;  // and `halo` lines
    const uint8_t* pre;  // the strip before the batch, h lines (the dirty compare)
    uint8_t* out;        // the block k turns on, out_lines = lines - 2k lines
    int lines, cols, k, h, halo, out_lines;
    int batch_k;         // K: the batch's turns
    int done;            // the batch's turns before this launch
    int* counts;         // K per-turn strip counts, zeroed before the batch
    uint8_t* bands;      // the batch's flat band output, or null
    uint8_t* dirty;      // the zeroed wire-tile grid on the batch's last launch, else null
    int dirty_cols;
    uint8_t* edges;      // the new strip's first and last K rows on the last launch, else null
    unsigned long long* sums;  // [S1, S2] before the batch, then after it
    int pre_sums, post_sums;   // this launch adds sums[0..1], sums[2..3]
    int pre_in_stage;          // the old strip is in the staged window (K <= 32, wide)
    long long n;               // h * cols, the strip's bytes
    int tiles_x, tiles;
    int run_len, runs;
};

__device__ __forceinline__ const uint8_t* line_ptr(const Args& a, int gr) {
    if (gr < a.halo) return a.top + static_cast<size_t>(gr) * a.cols;
    gr -= a.halo;
    if (gr < a.h) return a.mid + static_cast<size_t>(gr) * a.cols;
    return a.bot + static_cast<size_t>(gr - a.h) * a.cols;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 32 bytes as 8 little-endian words
__device__ __forceinline__ void from_uint4(uint4 lo, uint4 hi, uint32_t (&v)[8]) {
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// The byte loaders unroll fully, so that every index into `v` is a
// constant and `v` stays in registers.

// `count` (1..32) bytes at p, zeros after them
__device__ __forceinline__ void load_bytes(const uint8_t* p, int count, uint32_t (&v)[8]) {
#pragma unroll
    for (int b = 0; b < 32; ++b) {
        if (b % 4 == 0) v[b / 4] = 0;
        if (b < count) v[b / 4] |= static_cast<uint32_t>(p[b]) << (8 * (b % 4));
    }
}

// 32 cells of one row from column c, wrapping to column 0 where the row of
// `cols` cells ends (gol_pack32_wrapped's bytes)
__device__ __forceinline__ void load_wrapped(const uint8_t* row, int c, int cols,
                                             uint32_t (&v)[8]) {
#pragma unroll
    for (int b = 0; b < 32; ++b) {
        if (b % 4 == 0) v[b / 4] = 0;
        v[b / 4] |= static_cast<uint32_t>(row[c]) << (8 * (b % 4));
        if (++c == cols) c = 0;
    }
}

__device__ __forceinline__ uint32_t pack_bytes(const uint32_t (&v)[8]) {
    uint32_t word = 0;
#pragma unroll
    for (int g = 0; g < 8; ++g) word |= gol_pack4(v[g]) << (4 * g);
    return word;
}

// the bits of the 32 cells where the {0, 255} unpacking of `word` differs
// from the bytes `v`
__device__ __forceinline__ uint32_t diff_bits(uint32_t word, const uint32_t (&v)[8]) {
    uint32_t diff = 0;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
        diff |= gol_pack4(gol_unpack4((word >> (4 * g)) & 15u) ^ v[g]) << (4 * g);
    }
    return diff;
}

struct Sums {
    unsigned s, t;  // sum d_j and sum j d_j over a word's 32 byte positions j
};

// over the first `count` of the bytes `v`
__device__ __forceinline__ Sums byte_sums(const uint32_t (&v)[8], int count) {
    unsigned s = 0, t = 0;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
        const int keep = count - 4 * g;
        const uint32_t x = keep >= 4 ? v[g] : keep <= 0 ? 0u : v[g] & ((1u << (8 * keep)) - 1u);
        s = __dp4a(x, 0x01010101u, s);
        t = __dp4a(x, 0x03020100u + 0x04040404u * g, t);  // weights 4g .. 4g + 3
    }
    return {s, t};
}

// over the {0, 255} bytes of the set bits of `m`: bit position j has bit b
// set for the j of mask b below, so sum j m_j = sum 2^b popc(m & mask_b)
__device__ __forceinline__ Sums bit_sums(uint32_t m) {
    const unsigned t = __popc(m & 0xAAAAAAAAu) + 2u * __popc(m & 0xCCCCCCCCu) +
                       4u * __popc(m & 0xF0F0F0F0u) + 8u * __popc(m & 0xFF00FF00u) +
                       16u * __popc(m & 0xFFFF0000u);
    return {255u * __popc(m), 255u * t};
}

// a word whose first byte is at strip position p0 adds d to S1 and
// (n - p0 - j) d = (n - p0) s - t to S2, modulo kMod (each term < 2^30;
// n - p0 < 2^32, the entry point's limit on a summed strip)
__device__ __forceinline__ void add_sums(unsigned long long& s1, unsigned long long& s2, Sums w,
                                         unsigned n_minus_p0) {
    s1 += w.s;
    s2 += static_cast<unsigned long long>(n_minus_p0 % kMod) * w.s + (kMod - w.t % kMod);
}

// the CTA's two sums, each modulo kMod, added to dst[0..1]; every thread
// calls it
__device__ __forceinline__ void flush_sums(unsigned long long s1, unsigned long long s2,
                                           unsigned long long* dst, unsigned* shared) {
    const unsigned a = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(s1 % kMod));
    const unsigned b = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(s2 % kMod));
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(&shared[0], a);
        atomicAdd(&shared[1], b);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicAdd(&dst[0], static_cast<unsigned long long>(shared[0] % kMod));
        atomicAdd(&dst[1], static_cast<unsigned long long>(shared[1] % kMod));
    }
}

// byte offset of turn i's (0-based over the batch) top band in the flat
// band output: each earlier turn j wrote 2 bands of 2 (K - 1 - j) lines
__device__ __forceinline__ size_t band_base(int i, int batch_k, int cols) {
    const long long lines = 4LL * i * (batch_k - 1) - 2LL * i * (i - 1);
    return static_cast<size_t>(lines) * cols;
}

__device__ __forceinline__ void store_word(uint32_t word, uint8_t* dst, int count, bool wide) {
    if (wide && count == 32) {
        gol_unpack32_wide(word, dst);
    } else {
        gol_unpack_bytes(word, dst, count);
    }
}

// issue a tile's window as 16-byte copies into `stage`, one commit group
template <class T>
__device__ __forceinline__ void gather(const Args& a, int tile, uint8_t* stage, int wl) {
    const int ty = tile / a.tiles_x;
    const int r0 = ty * T::kRows;
    const int c0 = (tile - ty * a.tiles_x) * T::kCols;
    for (int e = threadIdx.x; e < wl * T::kChunks; e += T::kThreads) {
        const int line = e / T::kChunks;
        const int q = e - line * T::kChunks;
        const int gr = r0 + line;
        if (gr < a.lines) {
            cp_async16(stage + line * T::kLineBytes + 16 * q,
                       line_ptr(a, gr) + wrap(c0 - 32 + 16 * q, a.cols));
        }
    }
    cp_async_commit();
}

template <class T, bool WIDE>
__global__ void __launch_bounds__(T::kThreads) strip_steps_kernel(Args a) {
    // all of it dynamic (a kernel with static shared memory cannot opt in
    // to the SM's whole): two bit windows, the per-turn counts, the sums'
    // partials, then (WIDE) two staging buffers, 16-byte aligned
    extern __shared__ __align__(16) uint32_t smem[];
    const int k = a.k;
    const int wl = T::kRows + 2 * k;  // window lines
    const int window_words = wl * T::kP;
    uint32_t* const bits = smem;
    int* const turn_count = reinterpret_cast<int*>(smem + 2 * window_words);
    unsigned* const sum_shared = smem + 2 * window_words + kMaxTurns;
    uint8_t* const stage0 = reinterpret_cast<uint8_t*>(smem + 2 * window_words + kCounters);
    const int stage_bytes = wl * T::kLineBytes;
    const int tiles_y = a.tiles / a.tiles_x;

    if (threadIdx.x < kMaxTurns) turn_count[threadIdx.x] = 0;
    if (threadIdx.x < 4) sum_shared[threadIdx.x] = 0;
    unsigned long long pre1 = 0, pre2 = 0, post1 = 0, post2 = 0;

    const int tid = threadIdx.x;
    const int r = tid / T::kP;
    const int i = tid - r * T::kP;
    const int j0 = r * a.run_len;
    const bool active = r < a.runs;
    const int m = i == 0 ? 0 : i - 1;
    const int p = i + 1 == T::kP ? i : i + 1;
    const int lane = tid & 31;

    if (WIDE) gather<T>(a, blockIdx.x, stage0, wl);
    int it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
        const uint8_t* stage = stage0 + (it & 1) * stage_bytes;
        if (WIDE) {
            // the next tile's copies go out before this one's wait
            if (tile + gridDim.x < a.tiles) {
                gather<T>(a, tile + gridDim.x, stage0 + ((it + 1) & 1) * stage_bytes, wl);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
        }
        __syncthreads();

        const int ty = tile / a.tiles_x;
        const int r0 = ty * T::kRows;  // the window's first line, the tile's first output line
        const int c0 = (tile - ty * a.tiles_x) * T::kCols;
        // the input lines the tile owns, and the owned words on the board
        // (the loops over them step through all kWords, a constant divisor)
        const int own_lo = ty == 0 ? 0 : r0 + k;
        const int own_hi = ty == tiles_y - 1 ? a.lines : r0 + T::kRows + k;
        const int own_words = min(T::kWords, (a.cols - c0 + 31) / 32);
        const int s_lo = max(own_lo, a.halo);  // its strip lines
        const int s_hi = min(own_hi, a.halo + a.h);

        uint32_t* cur = bits;
        uint32_t* nxt = bits + window_words;
        for (int e = tid; e < window_words; e += T::kThreads) {
            const int line = e / T::kP;
            const int w = e - line * T::kP;
            const int gr = r0 + line;
            uint32_t word = 0;
            if (gr < a.lines) {
                uint32_t v[8];
                if (WIDE) {
                    const uint4* s =
                        reinterpret_cast<const uint4*>(stage + line * T::kLineBytes + 32 * w);
                    from_uint4(s[0], s[1], v);
                } else {
                    load_wrapped(line_ptr(a, gr), wrap(c0 + 32 * (w - 1), a.cols), a.cols, v);
                }
                word = pack_bytes(v);
                if (a.pre_sums && gr >= s_lo && gr < s_hi && w >= 1 && w <= own_words) {
                    const int gc = c0 + 32 * (w - 1);
                    add_sums(pre1, pre2, byte_sums(v, min(32, a.cols - gc)),
                             static_cast<unsigned>(
                                 a.n - (static_cast<long long>(gr - a.halo) * a.cols + gc)));
                }
            }
            cur[e] = word;
        }
        __syncthreads();

        for (int t = 1; t <= k; ++t) {
            const int js = max(j0, t);
            const int je = min(j0 + a.run_len, wl - t);
            if (active && js < je) {
                gol_walk(cur + m, cur + i, cur + p, nxt + i, (js - 1) * T::kP, js * T::kP,
                         T::kP, je - js, je * T::kP, Conway{});
            }
            __syncthreads();
            uint32_t* tmp = cur;
            cur = nxt;
            nxt = tmp;

            // the strip's count after turn t: its owned lines, its owned
            // words masked to the board's width
            int sum = 0;
            for (int e = tid; e < (s_hi - s_lo) * T::kWords; e += T::kThreads) {
                const int lr = e / T::kWords;
                const int tw = e % T::kWords;
                if (tw >= own_words) continue;
                const int bits_left = a.cols - (c0 + 32 * tw);
                const uint32_t mask = bits_left >= 32 ? ~0u : (1u << bits_left) - 1u;
                sum += __popc(cur[(s_lo + lr - r0) * T::kP + 1 + tw] & mask);
            }
            sum = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(sum)));
            if (lane == 0 && sum) atomicAdd(&turn_count[t - 1], sum);

            if (a.bands != nullptr) {
                const int turn = a.done + t - 1;  // over the batch, 0-based
                const int band = 2 * (a.halo - t);  // lines in each band
                const size_t base = band_base(turn, a.batch_k, a.cols);
                for (int side = 0; side < 2; ++side) {
                    const int b_lo = side == 0 ? t : a.h + t;  // the band's first line
                    const int lo = max(own_lo, b_lo);
                    const int hi = min(own_hi, b_lo + band);
                    uint8_t* out = a.bands + base + static_cast<size_t>(side) * band * a.cols;
                    for (int e = tid; e < (hi - lo) * T::kWords; e += T::kThreads) {
                        const int lr = e / T::kWords;
                        const int tw = e % T::kWords;
                        if (tw >= own_words) continue;
                        const int gc = c0 + 32 * tw;
                        store_word(cur[(lo + lr - r0) * T::kP + 1 + tw],
                                   out + static_cast<size_t>(lo + lr - b_lo) * a.cols + gc,
                                   min(32, a.cols - gc), WIDE);
                    }
                }
            }
        }

        // the tile's output lines: window lines k .. k + rows - 1
        const int rows = min(T::kRows, a.out_lines - r0);
        bool changed = false;
        for (int e = tid; e < rows * T::kWords; e += T::kThreads) {
            const int lr = e / T::kWords;
            const int tw = e % T::kWords;
            if (tw >= own_words) continue;
            const int gc = c0 + 32 * tw;
            const int count = min(32, a.cols - gc);
            const uint32_t mask = count == 32 ? ~0u : (1u << count) - 1u;
            const uint32_t word = cur[(k + lr) * T::kP + 1 + tw];
            const size_t at = static_cast<size_t>(r0 + lr) * a.cols + gc;
            store_word(word, a.out + at, count, WIDE);
            if (a.edges != nullptr) {
                // the reply's edges: rows [0, K) then [h - K, h) (both where h < 2K)
                const int j = r0 + lr;
                if (j < a.batch_k) {
                    store_word(word, a.edges + static_cast<size_t>(j) * a.cols + gc, count, WIDE);
                }
                if (j >= a.h - a.batch_k) {
                    store_word(word,
                               a.edges + static_cast<size_t>(j - a.h + 2 * a.batch_k) * a.cols + gc,
                               count, WIDE);
                }
            }
            if (a.post_sums) {
                add_sums(post1, post2, bit_sums(word & mask),
                         static_cast<unsigned>(a.n - static_cast<long long>(at)));
            }
            if (a.dirty != nullptr) {
                uint32_t v[8];
                if (WIDE && a.pre_in_stage) {
                    const uint4* s = reinterpret_cast<const uint4*>(
                        stage + (k + lr) * T::kLineBytes + 32 * (1 + tw));
                    from_uint4(s[0], s[1], v);
                } else if (WIDE && count == 32) {
                    const uint4* s = reinterpret_cast<const uint4*>(a.pre + at);
                    from_uint4(__ldg(s), __ldg(s + 1), v);
                } else {
                    load_bytes(a.pre + at, count, v);
                }
                changed |= (diff_bits(word, v) & mask) != 0;
            }
        }
        if (a.dirty != nullptr && __syncthreads_or(changed) && tid == 0) {
            a.dirty[(r0 / kWireRows) * a.dirty_cols + c0 / kWireCols] = 1;
        }
        __syncthreads();  // the windows and this stage are free for the next tiles
    }

    if (threadIdx.x < k && turn_count[threadIdx.x]) {
        atomicAdd(&a.counts[a.done + threadIdx.x], turn_count[threadIdx.x]);
    }
    if (a.pre_sums) flush_sums(pre1, pre2, a.sums, sum_shared);
    if (a.post_sums) flush_sums(post1, post2, a.sums + 2, sum_shared + 2);
}

inline size_t smem_bytes(int wl, int p, int line_bytes, bool wide) {
    return (2 * static_cast<size_t>(wl) * p + kCounters) * sizeof(uint32_t) +
           (wide ? 2 * static_cast<size_t>(wl) * line_bytes : 0);
}

template <class T, bool WIDE>
int launch(Args a, int max_ctas, cudaStream_t stream) {
    static std::atomic<bool> opted[kMaxDevices];
    // CTAs an SM holds at each k, per device: the occupancy API's answer
    // is a host computation, asked once
    static std::atomic<int> per_sm_at[kMaxDevices][kMaxTurns + 1];
    cudaError_t err = smem_opt_in_once(strip_steps_kernel<T, WIDE>, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int wl = T::kRows + 2 * a.k;
    const size_t smem = smem_bytes(wl, T::kP, T::kLineBytes, WIDE);
    int per_sm = per_sm_at[device][a.k].load(std::memory_order_relaxed);
    if (per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, strip_steps_kernel<T, WIDE>,
                                                            T::kThreads, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        per_sm_at[device][a.k].store(per_sm, std::memory_order_relaxed);
    }
    a.tiles_x = (a.cols + T::kCols - 1) / T::kCols;
    const long long tiles =
        static_cast<long long>((a.out_lines + T::kRows - 1) / T::kRows) * a.tiles_x;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    a.tiles = static_cast<int>(tiles);
    const long long slots = static_cast<long long>(per_sm) * sms;
    int grid = static_cast<int>(tiles < slots ? tiles : slots);
    if (max_ctas > 0 && max_ctas < grid) grid = max_ctas;
    const int runs_max = T::kThreads / T::kP;
    a.run_len = ((wl + runs_max - 1) / runs_max) | 1;
    a.runs = (wl + a.run_len - 1) / a.run_len;
    strip_steps_kernel<T, WIDE><<<grid, T::kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_tile(Args a, bool wide, int max_ctas, cudaStream_t stream) {
    return wide ? launch<T, true>(a, max_ctas, stream) : launch<T, false>(a, max_ctas, stream);
}

inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// k turns (1..32) of a strip batch of `batch_k` turns, of which `done` ran
// before this launch. The launch's block is R = batch_k - done lines at
// `top`, the strip's h lines at `mid` and R lines at `bot`, each a run of
// rows of `cols` uint8 cells; `out` receives the block k turns on,
// h + 2R - 2k lines (the strip, when done + k == batch_k), and must not
// alias any input. Turn i's (0-based) strip count is added to counts[i],
// which the caller zeroed before the batch; `bands`, when not null,
// receives every turn's top and bottom band in the flat layout of
// ops/strip_steps.py::band_offsets. On the batch's last launch, `dirty`,
// when not null, is the zeroed uint8 wire-tile grid of the (h, cols) strip
// (ceil(h / 64) x ceil(cols / 256)), and a tile is set to 1 where the new
// strip differs from the strip before the batch: `mid` on a launch with
// done == 0, else `pre`, which then must not be null. `edges`, when not
// null, receives on the last launch the new strip's first batch_k rows
// then its last batch_k rows (2 batch_k x cols; h >= batch_k). `sums`,
// when not null, is four zeroed uint64: the first launch adds S1 and S2 of
// the strip before the batch to sums[0..1], the last launch those of the
// new strip to sums[2..3], each congruent modulo 65521 to the adler32
// sums (h * cols < 2^32). `tile`: 1 the wide tile, 2 the small one
// (ops/strip_steps.py chooses by the output's size). `ctas` caps the
// persistent grid (0: as many as the SMs hold). Returns cudaGetLastError()
// after the launch (0 on success); cudaErrorInvalidValue for arguments
// outside these ranges.
int gol_strip_steps(const void* top, const void* mid, const void* bot, const void* pre,
                    void* out, int cols, int k, int h, int batch_k, int done, int* counts,
                    void* bands, void* dirty, void* sums, void* edges, int tile, int ctas,
                    void* stream) {
    const bool last = done + k == batch_k;
    if (k < 1 || k > kMaxTurns || h < 1 || cols < 1 || done < 0 || done + k > batch_k ||
        counts == nullptr || tile < 1 || tile > 2 || ctas < 0 || top == nullptr ||
        mid == nullptr || bot == nullptr || out == nullptr ||
        (last && done > 0 && dirty != nullptr && pre == nullptr) ||
        (edges != nullptr && h < batch_k) ||
        (sums != nullptr && static_cast<long long>(h) * cols > 0xffffffffLL)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Args a{};
    a.top = static_cast<const uint8_t*>(top);
    a.mid = static_cast<const uint8_t*>(mid);
    a.bot = static_cast<const uint8_t*>(bot);
    a.pre = done == 0 ? a.mid : static_cast<const uint8_t*>(pre);
    a.out = static_cast<uint8_t*>(out);
    a.cols = cols;
    a.k = k;
    a.h = h;
    a.batch_k = batch_k;
    a.done = done;
    a.halo = batch_k - done;
    a.lines = h + 2 * a.halo;
    a.out_lines = a.lines - 2 * k;
    a.counts = counts;
    a.bands = static_cast<uint8_t*>(bands);
    a.dirty = last ? static_cast<uint8_t*>(dirty) : nullptr;
    a.dirty_cols = (cols + kWireCols - 1) / kWireCols;
    a.edges = last ? static_cast<uint8_t*>(edges) : nullptr;
    a.sums = static_cast<unsigned long long*>(sums);
    a.pre_sums = sums != nullptr && done == 0;
    a.post_sums = sums != nullptr && last;
    a.n = static_cast<long long>(h) * cols;
    const bool wide = cols % 16 == 0 && aligned16(top) && aligned16(mid) && aligned16(bot) &&
                      aligned16(out) && (bands == nullptr || aligned16(bands)) &&
                      (a.dirty == nullptr || aligned16(a.pre)) &&
                      (a.edges == nullptr || aligned16(a.edges));
    a.pre_in_stage = wide && done == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return tile == 1 ? launch_tile<WideTile>(a, wide, ctas, s)
                     : launch_tile<SmallTile>(a, wide, ctas, s);
}

}  // extern "C"
