// The whole-board byte kernel: n turns of any B/S rule on a uint8 {0, 255}
// board held in one thread block's shared memory, in one launch.
//
// Replaces the JAX package's Pallas kernel K5,
// gol_distributed_final_tpu/ops/pallas_stencil.py:125 (byte_pallas_call,
// body _kernel at :115, turn byte_turn_fn at :91-112).
//
// Design. One block reads the board from device memory once, as 0/1 bytes,
// runs all n turns in dynamic shared memory (two copies of the board,
// ping-ponged, one __syncthreads() per turn) and writes it back once as
// {0, 255}. The torus wrap is index arithmetic (byte_step.cuh walks each
// column with the row above and its own row in registers). The Pallas kernel
// carried the board as int32 because Mosaic's vectors had no byte
// arithmetic; bytes in shared memory are the cheapest form here. n is a run
// time argument, so nothing is compiled per turn count. A block has
// min(1024, work units) threads rounded up to a warp, a unit being one
// column by 8 rows.
//
// What bounds it. Device memory is touched twice per launch, 2 * H * W
// bytes, so bytes never bound it past the first turns. The work is int32
// arithmetic. The function's cheapest form packs the board once, steps the
// bitboard at 12 instructions per 32 cells per turn for Conway and unpacks
// it once (ops/bitpack.py::byte_ops_per_cell); this kernel's byte
// arithmetic spends ~13x that per turn (two three-input adds for the 3x3
// sum, a select of the mask by the cell, a shift and an AND per cell). One
// board is one block on one of the card's 132 SMs, so the kernel reaches at
// most 1/132 of the card's integer rate; each turn ends on a block-wide
// barrier.
//
// The gate: both copies must fit the block's opt-in shared memory
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 B on an H100), so
// 2 * H * W <= that limit: 256^2 fits, 512^2 does not
// (ops/byte_board.py::fits). A thread block cluster of up to 8 blocks, each
// holding a row band and reading its halo rows from its neighbours' shared
// memory with one cluster barrier per turn, could keep boards up to ~960^2
// on chip (ROADMAP, kernel queue).
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "byte_step.cuh"
#include "smem_opt_in.cuh"

namespace {

__global__ void __launch_bounds__(1024)
byte_board_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int rows,
                  int cols, int n, ByteRule rule) {
    extern __shared__ uint8_t smem[];
    const int total = rows * cols;
    uint8_t* cur = smem;
    uint8_t* nxt = smem + total;
    for (int i = threadIdx.x; i < total; i += blockDim.x) cur[i] = in[i] != 0;
    __syncthreads();

    for (int t = 0; t < n; ++t) {
        byte_turn<true>(cur, nxt, cols, rows, cols, 0, rows, 0, cols, rule);
        __syncthreads();
        uint8_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    for (int i = threadIdx.x; i < total; i += blockDim.x) out[i] = cur[i] ? 255 : 0;
}

}  // namespace

extern "C" {

// n turns of `in` (uint8[rows, cols]) into `out`. Returns
// cudaGetLastError() after the launch (0 on success).
int gol_byte_board_step(const void* in, void* out, int rows, int cols, int n,
                        unsigned birth_mask, unsigned survive_mask, void* stream) {
    static std::atomic<bool> opted[kMaxDevices];
    const cudaError_t err = smem_opt_in_once(byte_board_kernel, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const ByteRule rule{birth_mask, survive_mask << 1};
    const int units = cols * ((rows + kByteChunkRows - 1) / kByteChunkRows);
    const int threads = units >= 1024 ? 1024 : ((units + 31) / 32) * 32;
    const size_t smem = 2 * static_cast<size_t>(rows) * cols;
    byte_board_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), rows, cols, n, rule);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
