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
// Design. Block b owns board b: it reads the board's words from device
// memory once, runs all n turns in dynamic shared memory (two copies of the
// board, ping-ponged, one __syncthreads() per turn) and writes the board and
// its int32 row popcounts once. The torus wrap is index arithmetic. n is a
// runtime argument, so nothing is compiled per turn count. Both packings are
// served by a template on the packed axis. A block has min(1024, words)
// threads rounded up to a warp, and every index it touches lies inside its
// own board's stride: at 64^2 (128 words) a block is 128 threads and no
// thread reads a neighbouring universe.
//
// What bounds it. Device memory is touched twice per launch, so bytes never
// bound it. The work is int32 logic, 12 instructions per word per turn for
// Conway at the least (ops/bitpack.py::ops_per_word; this kernel spends
// more, see tiled.cu). One board is one block on one of the card's 132 SMs,
// so a batch of one (K1) reaches at most 1/132 of the card's integer rate,
// and at small boards the serial chain of one turn's operations plus a
// block-wide barrier per turn is what it waits on. A batch fills the card
// with blocks: at 128^2 (word axis 0: 4 x 128 words) a block is 512 threads
// and 4 KiB of shared memory, so the 2048-thread SM holds 4 and ~528 boards
// fill 132 SMs; at 512^2 a block is 1024 threads and 64 KiB, 2 per SM.
//
// Prediction for the batch, written before its first run on the card: at
// the sessions bench shape (1000 x 128^2, n = 100) the bound is ~0.037 ms
// per launch, set by operations (1000 x 512 words x 100 turns x 12 =
// 6.1e8 instructions at 1.673e13 per s; bytes 2 x 4 x 512,000 B at
// 3.35 TB/s are ~1.2 us). Per board the inner loop is K1's. K1 at 512^2
// takes 10.5 us/turn for 8192 words on one SM, 13.5x that SM's share of
// the bound; the batch runs the same loop on every SM at once (1000 boards
// are 1.9 waves of 528 resident blocks), so expect ~13x the bound, about
// 0.5 ms per launch, and within 5-25x of it.
//
// The gate, per board: both copies must fit the block's opt-in shared
// memory (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 B on an H100),
// so 8 * rows * cols <= that limit (ops/whole_board.py::fits).
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "bit_step.cuh"
#include "smem_opt_in.cuh"

namespace {

template <int WORD_AXIS>
__global__ void __launch_bounds__(1024)
whole_board_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   int32_t* __restrict__ row_counts, int rows, int cols, int n,
                   GolRule rule) {
    extern __shared__ uint32_t smem[];
    const int total = rows * cols;
    // this block's board: the batch strides are whole boards and row vectors
    in += static_cast<size_t>(blockIdx.x) * total;
    out += static_cast<size_t>(blockIdx.x) * total;
    if (row_counts != nullptr) row_counts += static_cast<size_t>(blockIdx.x) * rows;
    uint32_t* cur = smem;
    uint32_t* nxt = smem + total;
    for (int i = threadIdx.x; i < total; i += blockDim.x) cur[i] = in[i];
    __syncthreads();

    for (int t = 0; t < n; ++t) {
        for (int i = threadIdx.x; i < total; i += blockDim.x) {
            const int r = i / cols;
            const int c = i - r * cols;
            const int ru = (r == 0 ? rows : r) - 1;
            const int rd = (r + 1 == rows) ? 0 : r + 1;
            const int cl = (c == 0 ? cols : c) - 1;
            const int cr = (c + 1 == cols) ? 0 : c + 1;
            const uint32_t* up = cur + ru * cols;
            const uint32_t* md = cur + r * cols;
            const uint32_t* dn = cur + rd * cols;
            const uint32_t x[3][3] = {{up[cl], up[c], up[cr]},
                                      {md[cl], md[c], md[cr]},
                                      {dn[cl], dn[c], dn[cr]}};
            nxt[i] = gol_life_word<WORD_AXIS>(x, rule);
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

template <int WORD_AXIS>
int launch(const void* in, void* out, void* row_counts, int batch, int rows, int cols,
           int n, GolRule rule, cudaStream_t stream) {
    static std::atomic<bool> opted[kMaxDevices];
    const int total = rows * cols;
    const size_t smem = 2 * static_cast<size_t>(total) * sizeof(uint32_t);
    const int threads = total >= 1024 ? 1024 : ((total + 31) / 32) * 32;
    const cudaError_t err = smem_opt_in_once(whole_board_kernel<WORD_AXIS>, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    whole_board_kernel<WORD_AXIS><<<batch, threads, smem, stream>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
        static_cast<int32_t*>(row_counts), rows, cols, n, rule);
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
// results' rows into int32[batch, rows]. Returns cudaGetLastError() after
// the launch (0 on success).
int gol_whole_board_step(const void* in, void* out, void* row_counts, int batch, int rows,
                         int cols, int word_axis, int n, unsigned common, unsigned dead_only,
                         unsigned live_only, void* stream) {
    const GolRule rule{common, dead_only, live_only};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (word_axis == 0) return launch<0>(in, out, row_counts, batch, rows, cols, n, rule, s);
    return launch<1>(in, out, row_counts, batch, rows, cols, n, rule, s);
}

}  // extern "C"
