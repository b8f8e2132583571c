// The whole-board bitboard kernel: n turns of any B/S rule on packed boards,
// each held in one thread block's shared memory, plus each board's row
// popcounts, in one launch. The grid runs over a batch of B independent
// boards (universes); a single board is the batch of one.
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
// turn for Conway at the least (ops/bitpack.py::ops_per_word). One board is
// one block, so a batch of one (K1) reaches at most 1/132 of the card; a
// batch fills the card with blocks, and then what a block spends per word
// and how many blocks reside per SM set the time.
//
// Design. Block b owns board b: it reads the board's words from device
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
// The gate, per board: both copies must fit the block's opt-in shared
// memory (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 B on an H100),
// so 8 * rows * cols <= that limit (ops/whole_board.py::fits).
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "bit_step.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // the largest block plan() chooses

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

template <int WORD_AXIS, class Rule>
__global__ void __launch_bounds__(kMaxThreads)
whole_board_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   int32_t* __restrict__ row_counts, int rows, int cols, int n,
                   int run_len, int runs, Rule rule) {
    extern __shared__ uint32_t smem[];
    const int total = rows * cols;
    // this block's board: the batch strides are whole boards and row vectors
    in += static_cast<size_t>(blockIdx.x) * total;
    out += static_cast<size_t>(blockIdx.x) * total;
    if (row_counts != nullptr) row_counts += static_cast<size_t>(blockIdx.x) * rows;
    uint32_t* cur = smem;
    uint32_t* nxt = smem + total;
    for (int i = threadIdx.x; i < total; i += blockDim.x) cur[i] = in[i];

    const int ostride = WORD_AXIS == 0 ? 1 : cols;
    const int items = (WORD_AXIS == 0 ? rows : cols) * runs;
    const int tid = threadIdx.x;
    const Run own = make_run<WORD_AXIS>(tid, rows, cols, run_len, runs);
    __syncthreads();

    for (int t = 0; t < n; ++t) {
        if (tid < items) {
            gol_walk(cur + own.m, cur + own.c, cur + own.p, nxt + own.c, own.prev_off,
                     own.off, ostride, own.len, own.last_next_off, rule);
        }
        // more runs than threads only where a board's packed axis is wider
        // than the largest block (> 1024 words)
        for (int item = tid + blockDim.x; item < items; item += blockDim.x) {
            const Run w = make_run<WORD_AXIS>(item, rows, cols, run_len, runs);
            gol_walk(cur + w.m, cur + w.c, cur + w.p, nxt + w.c, w.prev_off, w.off,
                     ostride, w.len, w.last_next_off, rule);
        }
        __syncthreads();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    for (int i = threadIdx.x; i < total; i += blockDim.x) out[i] = cur[i];
    if (row_counts == nullptr) return;
    // one warp per row: strided __popc, then a shuffle reduction
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    for (int r = threadIdx.x >> 5; r < rows; r += warps) {
        int sum = 0;
        for (int c = lane; c < cols; c += 32) sum += __popc(cur[r * cols + c]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) row_counts[r] = sum;
    }
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

template <int WORD_AXIS, class Rule>
int launch(const void* in, void* out, void* row_counts, int batch, int rows, int cols,
           int n, Rule rule, cudaStream_t stream) {
    static std::atomic<bool> opted[kMaxDevices];
    const size_t smem = 2 * static_cast<size_t>(rows) * cols * sizeof(uint32_t);
    int sms = 0, sm_threads = 0, sm_smem = 0;
    cudaError_t err = sm_shape(sms, sm_threads, sm_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int P = WORD_AXIS == 0 ? rows : cols;
    const int Q = WORD_AXIS == 0 ? cols : rows;
    const Plan p = plan(P, Q, batch, sms, sm_threads, sm_smem, smem);
    err = smem_opt_in_once(whole_board_kernel<WORD_AXIS, Rule>, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    whole_board_kernel<WORD_AXIS, Rule><<<batch, p.threads, smem, stream>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
        static_cast<int32_t*>(row_counts), rows, cols, n, p.run_len, p.runs, rule);
    return static_cast<int>(cudaGetLastError());
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
        if (word_axis == 0) return launch<0>(in, out, row_counts, batch, rows, cols, n, rule, s);
        return launch<1>(in, out, row_counts, batch, rows, cols, n, rule, s);
    });
}

}  // extern "C"
