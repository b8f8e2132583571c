// The whole-board byte kernel: n turns of any B/S rule on a uint8 {0, 255}
// board held on chip, in one launch. Where an axis of the board is a
// multiple of 32 the board steps as a bitboard in the shared memory of a
// thread block cluster; any other board steps as bytes in one block.
//
// Replaces the JAX package's Pallas kernel K5,
// gol_distributed_final_tpu/ops/pallas_stencil.py:125 (byte_pallas_call,
// body _kernel at :115, turn byte_turn_fn at :91-112).
//
// What bounds it. Device memory is touched twice per launch, 2 * H * W
// bytes, so bytes never bound it past the first turns. The work is int32
// arithmetic, in its cheapest form: pack the board once, step the bitboard
// at 12 instructions per 32 cells per turn for Conway, unpack it once
// (ops/bitpack.py::byte_ops_per_cell). One launch must hold the whole board
// on chip for all n turns, so it runs on at most the SMs of one cluster, and
// every turn ends on a barrier across them.
//
// The bit form (byte_board_bits_kernel). Bytes at the device-memory boundary
// only:
// - Packing. The packed axis must close on itself, so it is one that is a
//   multiple of 32: columns where W % 32 == 0 (a thread packs 32 cells of a
//   row from two 16-byte loads, byte_pack.cuh), else rows where H % 32 == 0
//   (a warp takes 32 rows of one column, a lane a row, and one
//   __ballot_sync(byte != 0) is the word). On chip both look the same: Q
//   lines (rows, or columns) of P words, a line's words side by side, so the
//   turn loop does not know the packing.
// - A cluster of C blocks (C = 1, 2, 4 or 8; ops/byte_board.py::launch_plan
//   chooses C, the halo depth d and the form, and the entry point runs
//   them). Block b holds the band of Q / C lines from b * Q / C in its own
//   shared memory, two copies ping-ponged; the band axis is the one that is
//   not packed, so a line is contiguous words. The blocks form a ring, which
//   closes the torus across the lines.
// - The cluster's barrier costs far more than a block's (measured: a 64^2
//   board took 0.19 us a turn on one block and 0.6 us on a cluster of two
//   that met every turn). So each copy carries d halo lines on each side
//   (16, at most the band) and the cluster meets once per d turns. In a
//   phase of d turns a block steps its own copy with __syncthreads() between
//   turns, turn s stepping only the slots still right (s from either end:
//   the shrinking cone), so after d turns exactly the band is; then the
//   cluster meets, every block reads its next halo lines from its two
//   neighbours' bands through distributed shared memory (map_shared_rank),
//   and the cluster meets again before any band is stepped on. The halo is
//   work done twice, (band + d) / band on average: 1.25x for 512^2 on 8
//   blocks at d = 16.
//   Pushing the bands' ends into the neighbours' double-buffered inboxes at
//   a phase's last turn, for one meeting a phase, measured no faster.
// - One block (C = 1) holds the whole torus: no halo, the first and last
//   lines are each other's neighbours by index, one __syncthreads() a turn.
// - Unpacking mirrors packing: 16-byte stores of {0, 255}, or a byte a lane.
//
// The byte form (byte_board_bytes_kernel), for boards where neither axis is
// a multiple of 32 (16^2, 24 x 33): one block, two uint8 copies in shared
// memory, byte_step.cuh's turn, the torus by index arithmetic.
//
// The gate is ops/byte_board.py::fits: the form's shared memory, and the
// size past which the byte tiles on the whole card are faster (MAX_CELLS,
// measured: a cluster is 8 SMs of 132, and from about 200^2 on the tiles'
// launches of 32 turns take less device time than one launch here).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "bit_step.cuh"
#include "byte_pack.cuh"
#include "byte_step.cuh"
#include "smem_opt_in.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kThreadAim = 512;      // runs per block, about

enum Form { kBitsCols = 0, kBitsRows = 1, kBytes = 2 };

// One thread's share of a band copy: the slots [j0, j0 + run_len) at packed
// index i (a copy's slot s is line s - depth of the band).
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

// The run's slots within [lo, hi) of `nxt` from `cur`. A copy without halo
// slots is the whole torus, and its first and last lines are each other's
// neighbours.
template <class Rule>
__device__ __forceinline__ void step_run(const Run& w, const uint32_t* cur, uint32_t* nxt,
                                         int P, int run_len, int slots, int lo, int hi,
                                         const Rule& rule) {
    const int js = max(w.j0, lo);
    const int je = min(w.j0 + run_len, hi);
    if (js < je) {
        const int before = (js == 0 ? slots : js) - 1;
        const int after = je == slots ? 0 : je;
        gol_walk(cur + w.m, cur + w.c, cur + w.p, nxt + w.c, before * P, js * P, P, je - js,
                 after * P, rule);
    }
}

// The barrier between two turns: the cluster's, or the block's own.
template <int CLUSTER>
__device__ __forceinline__ void meet() {
    if (CLUSTER > 1) cg::this_cluster().sync(); else __syncthreads();
}

template <int CLUSTER, class Rule>
__global__ void __launch_bounds__(kMaxThreads)
byte_board_bits_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int rows,
                       int cols, int n, int pack_rows, int wide, int depth, int run_len,
                       int runs, Rule rule) {
    extern __shared__ uint32_t words[];
    const int P = (pack_rows ? rows : cols) / 32;  // words per line
    const int Q = pack_rows ? cols : rows;         // lines
    const int band = Q / CLUSTER;
    const int rank = CLUSTER > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
    const int line0 = rank * band;
    const int slots = band + 2 * depth;
    const int copy = slots * P;
    uint32_t* cur = words;
    uint32_t* nxt = words + copy;

    // the band and its halo lines, from device memory: slot s holds line
    // line0 - depth + s of the torus (depth <= band <= Q: one wrap at most)
    if (pack_rows) {
        const int lane = threadIdx.x & 31;
        const int warps = blockDim.x >> 5;
        for (int e = threadIdx.x >> 5; e < copy; e += warps) {
            const int i = e / slots;
            const int s = e - i * slots;
            int line = line0 - depth + s;
            line = line < 0 ? line + Q : (line >= Q ? line - Q : line);
            const uint8_t byte = in[static_cast<size_t>(32 * i + lane) * cols + line];
            const uint32_t word = __ballot_sync(0xffffffffu, byte != 0);
            if (lane == 0) cur[s * P + i] = word;
        }
    } else {
        for (int e = threadIdx.x; e < copy; e += blockDim.x) {
            const int s = e / P;
            const int i = e - s * P;
            int line = line0 - depth + s;
            line = line < 0 ? line + Q : (line >= Q ? line - Q : line);
            const uint8_t* src = in + static_cast<size_t>(line) * cols + 32 * i;
            cur[e] = wide ? gol_pack32_wide(src) : gol_pack32_wrapped(src, 0, 32);
        }
    }

    const int items = P * runs;
    const int tid = threadIdx.x;
    const Run own = make_run(tid, P, run_len);
    // every block of the cluster is running before any reads another's
    // shared memory
    meet<CLUSTER>();

    for (int left = n; left > 0;) {
        // A phase of r turns on the block's own copy. One block holds the
        // whole torus and runs all n in one phase. A block of a cluster
        // runs r <= depth: turn s steps the slots that are still right,
        // depth - r + s from either end, so after turn r exactly the band is.
        const int r = CLUSTER == 1 ? left : min(depth, left);
        left -= r;
        for (int s = 1; s <= r; ++s) {
            const int lo = CLUSTER == 1 ? 0 : depth - r + s;
            const int hi = slots - lo;
            if (tid < items) step_run(own, cur, nxt, P, run_len, slots, lo, hi, rule);
            // more runs than threads only for a band wider than the largest block
            for (int item = tid + blockDim.x; item < items; item += blockDim.x) {
                step_run(make_run(item, P, run_len), cur, nxt, P, run_len, slots, lo, hi, rule);
            }
            __syncthreads();
            uint32_t* tmp = cur;
            cur = nxt;
            nxt = tmp;
        }
        if (CLUSTER > 1 && left > 0) {
            // The halo lines for the next phase, from the neighbours' bands
            // through distributed shared memory: the block above's last
            // `depth` lines and the block below's first. Two meetings a
            // phase: every band is finished before any is read, and every
            // halo is read before any band is stepped on.
            cg::cluster_group cluster = cg::this_cluster();
            cluster.sync();
            const uint32_t* above = cluster.map_shared_rank(cur, rank == 0 ? CLUSTER - 1 : rank - 1);
            const uint32_t* below = cluster.map_shared_rank(cur, rank + 1 == CLUSTER ? 0 : rank + 1);
            for (int e = tid; e < depth * P; e += blockDim.x) {
                cur[e] = above[band * P + e];
                cur[(band + depth) * P + e] = below[depth * P + e];
            }
            cluster.sync();
        }
    }

    // the band, back to bytes
    if (pack_rows) {
        const int lane = threadIdx.x & 31;
        const int warps = blockDim.x >> 5;
        for (int e = threadIdx.x >> 5; e < band * P; e += warps) {
            const int i = e / band;
            const int j = e - i * band;
            const uint32_t word = cur[(depth + j) * P + i];
            out[static_cast<size_t>(32 * i + lane) * cols + line0 + j] =
                (word >> lane & 1u) ? 255 : 0;
        }
    } else {
        const uint32_t* own_lines = cur + depth * P;
        for (int e = threadIdx.x; e < band * P; e += blockDim.x) {
            const int j = e / P;
            const int i = e - j * P;
            uint8_t* dst = out + static_cast<size_t>(line0 + j) * cols + 32 * i;
            if (wide) {
                gol_unpack32_wide(own_lines[e], dst);
            } else {
                gol_unpack_bytes(own_lines[e], dst, 32);
            }
        }
    }
    // the last read of another block's shared memory lies before the last
    // meeting, so a block may leave as soon as it has stored its band
}

__global__ void __launch_bounds__(kMaxThreads)
byte_board_bytes_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int rows,
                        int cols, int n, ByteRule rule) {
    extern __shared__ uint8_t smem[];
    const int total = rows * cols;
    uint8_t* cur = smem;
    uint8_t* nxt = smem + total;
    for (int i = threadIdx.x; i < total; i += blockDim.x) cur[i] = in[i] != 0;
    __syncthreads();

    for (int t = 0; t < n; ++t) {
        byte_turn(cur, nxt, rows, cols, rule);
        __syncthreads();
        uint8_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    for (int i = threadIdx.x; i < total; i += blockDim.x) out[i] = cur[i] ? 255 : 0;
}

// One block holds the torus itself (depth 0); a block of a cluster a halo
// of 1 to band lines on each side.
template <int CLUSTER, class Rule>
int launch_bits(const void* in, void* out, int rows, int cols, int n, int pack_rows, int depth,
                Rule rule, cudaStream_t stream) {
    static std::atomic<bool> opted[kMaxDevices];
    const int P = (pack_rows ? rows : cols) / 32;
    const int Q = pack_rows ? cols : rows;
    const int band = Q / CLUSTER;
    if (Q % CLUSTER != 0 || (CLUSTER == 1 ? depth != 0 : depth < 1 || depth > band)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int slots = band + 2 * depth;
    // the shortest odd runs that keep the block near kThreadAim threads
    int run_len = 1;
    while (run_len < slots && P * ((slots + run_len - 1) / run_len) > kThreadAim) run_len += 2;
    const int runs = (slots + run_len - 1) / run_len;
    const long long items = static_cast<long long>(P) * runs;
    const int threads = items >= kMaxThreads ? kMaxThreads : static_cast<int>((items + 31) / 32 * 32);
    const size_t smem = 2 * static_cast<size_t>(slots) * P * sizeof(uint32_t);
    cudaError_t err = smem_opt_in_once(byte_board_bits_kernel<CLUSTER, Rule>, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int wide = gol_wide_ok(in, out);

    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(CLUSTER);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attribute[1];
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = CLUSTER;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = 1;
    // a cluster the card cannot schedule is refused here, and the caller raises
    err = cudaLaunchKernelEx(&config, byte_board_bits_kernel<CLUSTER, Rule>,
                             static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), rows,
                             cols, n, pack_rows, wide, depth, run_len, runs, rule);
    if (err != cudaSuccess) {
        cudaGetLastError();  // the refusal is returned, not left pending
        return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}

int launch_bytes(const void* in, void* out, int rows, int cols, int n, unsigned birth_mask,
                 unsigned survive_mask, cudaStream_t stream) {
    static std::atomic<bool> opted[kMaxDevices];
    const cudaError_t err = smem_opt_in_once(byte_board_bytes_kernel, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const ByteRule rule{birth_mask, survive_mask << 1};
    const long long units =
        static_cast<long long>(cols) * ((rows + kByteChunkRows - 1) / kByteChunkRows);
    const int threads = units >= kMaxThreads ? kMaxThreads : static_cast<int>((units + 31) / 32 * 32);
    const size_t smem = 2 * static_cast<size_t>(rows) * cols;
    byte_board_bytes_kernel<<<1, threads, smem, stream>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), rows, cols, n, rule);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n >= 1 turns of `in` (uint8[rows, cols]) into `out`, in the form, on the
// cluster and at the halo depth given (ops/byte_board.py::launch_plan plans
// them): form 0 packs columns, 1 packs rows, 2 steps bytes; cluster 1, 2,
// 4, 8 or 16 blocks, 16 past the portable limit and refused unless the card
// allows it; depth 0 on one block, else 1 to the band. Returns the launch's
// CUDA error (0 on success); cudaErrorInvalidValue for a form the shape
// cannot take, a cluster that does not divide the lines, a depth outside
// those, or a cluster with the byte form.
int gol_byte_board_step_as(const void* in, void* out, int rows, int cols, int n,
                           unsigned birth_mask, unsigned survive_mask, int form, int cluster,
                           int depth, void* stream) {
    if (rows < 1 || cols < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (form == kBytes) {
        if (cluster != 1 || depth != 0) return static_cast<int>(cudaErrorInvalidValue);
        return launch_bytes(in, out, rows, cols, n, birth_mask, survive_mask, s);
    }
    const int pack_rows = form == kBitsRows;
    if (form < 0 || form > kBytes || (pack_rows ? rows : cols) % 32 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return gol_with_bs_rule(birth_mask, survive_mask, [&](auto rule) {
        switch (cluster) {
            case 1: return launch_bits<1>(in, out, rows, cols, n, pack_rows, depth, rule, s);
            case 2: return launch_bits<2>(in, out, rows, cols, n, pack_rows, depth, rule, s);
            case 4: return launch_bits<4>(in, out, rows, cols, n, pack_rows, depth, rule, s);
            case 8: return launch_bits<8>(in, out, rows, cols, n, pack_rows, depth, rule, s);
            case 16: return launch_bits<16>(in, out, rows, cols, n, pack_rows, depth, rule, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    });
}

}  // extern "C"
