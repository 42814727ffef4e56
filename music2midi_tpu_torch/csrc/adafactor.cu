// Adafactor (the HF-transformers defaults) over many fp32 tensors at
// once, for Hopper (sm_90a): every leaf of a train step in four launches.
//
// Replaces no TPU kernel: the JAX package leaves its optimizer
// (music2midi_tpu/train/adafactor.py::adafactor_hf, an optax transform)
// to XLA, which fuses it into the train step's one program.  The port ran
// it as a Python loop over the model's leaves (146 for the model of
// record: 114 matrices, 32 vectors, 30.4 M parameters), about 20 eager
// ops a matrix and ~2,700 launches a step, each a few us of work on the
// card behind 10-20 us of host dispatch.  This file is that loop's
// arithmetic, train/adafactor.py::Adafactor (its plain version serves CPU
// tensors), with no step left out and everything in fp32:
//
//   lr    = max(sqrt(sum p^2 / n), 1e-3) * rel     (relative step: host)
//   sq    = g^2 + 1e-30
//   row   = beta2 row + (1 - beta2) mean_c sq       (a matrix: R values)
//   col   = beta2 col + (1 - beta2) mean_r sq       (C values)
//   upd   = rsqrt(row / mean(row)) rsqrt(col) g
//   v     = beta2 v + (1 - beta2) sq; upd = rsqrt(v) g     (a vector)
//   upd  /= max(sqrt(sum upd^2 / n) / 1.0, 1)
//   p    -= upd lr
//
// Four phases, each one launch over every leaf of the step (the host
// all-reduces a slice of the statistics over tensor parallelism between
// them, where a leaf is a tp rank's slice of a matrix):
//   0 stats    tiles: reads p and g; per tile the partial sum of p^2, of
//              each row's sq over the tile's columns and of each column's
//              over its rows; a vector's v.  The leaf's last tile to finish
//              folds the partials into the statistics buffer: sum p^2, the
//              row sums, the column sums.
//   1 moments  a block a leaf: the row and column EMAs, and the sum of the
//              new row moments (the row factor's mean).
//   2 norm     tiles: reads g and the factors; sum upd^2, folded by the
//              leaf's last tile.
//   3 apply    tiles: reads g and p, recomputes upd, clips, scales and
//              writes p.
// A tile is 32 rows x 128 columns of one leaf (a vector is one row), a
// block of 256 threads: warp w takes rows w, w + 8, w + 16, w + 24, lane
// l columns l, l + 32, l + 64, l + 96, so a warp's load is 128
// contiguous bytes; a thread's 16 elements' loads are in flight together,
// and at ~80 registers three blocks share an SM, so one block's loads run
// while another computes.
//
// Determinism: no float atomics.  Partials go to scratch at fixed places
// and are folded in a fixed order; the last-tile election is an integer
// atomic (a counter a leaf, put back to 0 by the block that folds), and
// which block folds does not change the order it folds in.  So two runs
// of a step give the same bits.  The squares, sqrt, divisions and
// 1 / sqrt are rounded as the plain version's tensor ops round them; the
// sums are taken in another order than PyTorch's, so the moments and the
// step agree with the plain version to the rounding of a sum.
//
// The step's float32 scalars (beta2, 1 - beta2, the relative step) are
// computed on the host and passed by value, as are the gradients'
// addresses (they move every step: zero_grad sets them to None); the
// rest (parameters, moments, offsets) is a table on the card, written
// once for a set of leaves.  Nothing is read back.
//
// Bound on the H100: the bytes.  Phase 0 reads p and g, phase 2 g, phase
// 3 g and p and writes p: 24 bytes an element, 730 MB a step for the
// model of record, 0.22 ms at 3.35 TB/s; reading p and g and writing p
// once is the floor (0.11 ms).  The factors, the scratch partials (1/32
// and 1/128 of the elements) and the statistics are small beside that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 256;  // gradient addresses in the arguments
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;
constexpr int kTileCols = 128;
constexpr int kRowsPerWarp = kTileRows / kWarps;  // 4
constexpr int kColsPerLane = kTileCols / 32;      // 4
constexpr float kEps1 = 1e-30f;  // added to g^2
constexpr float kEps2 = 1e-3f;   // the floor of RMS(param)
constexpr float kClip = 1.0f;    // the update's RMS bound

// One leaf, fixed while the optimizer steps the same set of leaves.
struct AdafactorLeaf {
    float* p;
    float* row;  // R row moments; a vector's full moment v
    float* col;  // C column moments; null for a vector
    int64_t rows, cols;  // R, C; a vector is one row of C
    int64_t first_tile, col_tiles, n_tiles;
    int64_t part, row_part, col_part;  // offsets of the partials in scratch
    int64_t psq, row_sum, col_sum, rfac, usq;  // offsets in the statistics
    float n_all, rows_all, cols_all;  // n, R and C of the whole matrix
    int pad;
};

// One launch's arguments, passed by value (2,112 bytes).
struct AdafactorArgs {
    const float* g[kMaxLeaves];
    const AdafactorLeaf* leaves;
    const int* tile_leaf;  // the leaf of each tile
    float* stats;
    float* scratch;
    unsigned int* counters;  // a leaf's finished tiles, 0 between passes
    int n_leaves, n_tiles;
    float beta2, one_minus, rel;
    int pad;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;  // lane 0's is the one used
}

// The block's sum of v, in a fixed order; the same value in every thread.
__device__ float block_sum(float v) {
    __shared__ float part[kWarps];
    v = warp_sum(v);
    __syncthreads();  // an earlier call's readers are done with part
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w];
    return s;
}

// True in every thread of the block that finishes its leaf's pass last;
// that block then sees every other block's partials.
__device__ bool last_tile(unsigned int* counter, int64_t n_tiles) {
    __shared__ bool last;
    __threadfence();  // this block's partials before its count
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == n_tiles - 1;
    __syncthreads();
    if (last) __threadfence();
    return last;
}

// The sum over the leaf's tiles of scratch[part + k], in a fixed order,
// by the block that folds; resets the leaf's counter.
__device__ float fold_tiles(const AdafactorArgs& a, const AdafactorLeaf& L,
                            int leaf) {
    float t = 0.0f;
    for (int64_t k = threadIdx.x; k < L.n_tiles; k += kThreads)
        t += __ldcg(a.scratch + L.part + k);
    t = block_sum(t);
    if (threadIdx.x == 0) a.counters[leaf] = 0u;
    return t;
}

struct Tile {
    int leaf;
    int64_t lt, rt, ct;  // index in its leaf, row tile, column tile
};

__device__ __forceinline__ Tile tile_of(const AdafactorArgs& a,
                                        const AdafactorLeaf*& L) {
    Tile t;
    t.leaf = a.tile_leaf[blockIdx.x];
    L = a.leaves + t.leaf;
    t.lt = blockIdx.x - L->first_tile;
    t.rt = t.lt / L->col_tiles;
    t.ct = t.lt % L->col_tiles;
    return t;
}

__global__ void __launch_bounds__(kThreads)
adafactor_stats_kernel(const AdafactorArgs a) {
    __shared__ float col_s[kWarps][kTileCols];
    const AdafactorLeaf* Lp;
    const Tile t = tile_of(a, Lp);
    const AdafactorLeaf L = *Lp;
    const float* __restrict__ g = a.g[t.leaf];
    const bool factored = L.col != nullptr;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t r0 = t.rt * kTileRows + warp, c0 = t.ct * kTileCols + lane;

    float pv[kRowsPerWarp][kColsPerLane], gv[kRowsPerWarp][kColsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
            const int64_t r = r0 + i * kWarps, c = c0 + 32 * j;
            const bool in = r < L.rows && c < L.cols;
            pv[i][j] = in ? L.p[r * L.cols + c] : 0.0f;
            gv[i][j] = in ? g[r * L.cols + c] : 0.0f;
        }
    }
    float psq = 0.0f, col_acc[kColsPerLane] = {};
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        const int64_t r = r0 + i * kWarps;
        float row_acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
            const int64_t c = c0 + 32 * j;
            if (r < L.rows && c < L.cols) {
                psq += __fmul_rn(pv[i][j], pv[i][j]);
                const float sq = __fmul_rn(gv[i][j], gv[i][j]) + kEps1;
                row_acc += sq;
                col_acc[j] += sq;
                if (!factored) {
                    float* v = L.row + c;  // a vector: r is 0
                    *v = fmaf(a.one_minus, sq, *v * a.beta2);
                }
            }
        }
        if (factored) {
            row_acc = warp_sum(row_acc);
            if (lane == 0 && r < L.rows)
                a.scratch[L.row_part + t.ct * L.rows + r] = row_acc;
        }
    }
    psq = block_sum(psq);
    if (threadIdx.x == 0) a.scratch[L.part + t.lt] = psq;
    if (factored) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j)
            col_s[warp][lane + 32 * j] = col_acc[j];
        __syncthreads();
        const int64_t c = t.ct * kTileCols + threadIdx.x;
        if (threadIdx.x < kTileCols && c < L.cols) {
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) s += col_s[w][threadIdx.x];
            a.scratch[L.col_part + t.rt * L.cols + c] = s;
        }
    }

    if (!last_tile(a.counters + t.leaf, L.n_tiles)) return;
    const float total = fold_tiles(a, L, t.leaf);
    if (threadIdx.x == 0) a.stats[L.psq] = total;
    if (!factored) return;
    const int64_t row_tiles = L.n_tiles / L.col_tiles;
    for (int64_t r = threadIdx.x; r < L.rows; r += kThreads) {
        float s = 0.0f;
        for (int64_t k = 0; k < L.col_tiles; ++k)
            s += __ldcg(a.scratch + L.row_part + k * L.rows + r);
        a.stats[L.row_sum + r] = s;
    }
    for (int64_t c = threadIdx.x; c < L.cols; c += kThreads) {
        float s = 0.0f;
        for (int64_t k = 0; k < row_tiles; ++k)
            s += __ldcg(a.scratch + L.col_part + k * L.cols + c);
        a.stats[L.col_sum + c] = s;
    }
}

__global__ void __launch_bounds__(kThreads)
adafactor_moments_kernel(const AdafactorArgs a) {
    const AdafactorLeaf L = a.leaves[blockIdx.x];
    if (L.col == nullptr) return;  // a vector's v is set by the stats pass
    float s = 0.0f;
    for (int64_t r = threadIdx.x; r < L.rows; r += kThreads) {
        const float mean = a.stats[L.row_sum + r] / L.cols_all;
        const float m = fmaf(a.one_minus, mean, L.row[r] * a.beta2);
        L.row[r] = m;
        s += m;
    }
    s = block_sum(s);
    if (threadIdx.x == 0) a.stats[L.rfac] = s;
    for (int64_t c = threadIdx.x; c < L.cols; c += kThreads) {
        const float mean = a.stats[L.col_sum + c] / L.rows_all;
        L.col[c] = fmaf(a.one_minus, mean, L.col[c] * a.beta2);
    }
}

// Apply = false: sum upd^2 (phase 2); true: the parameter step (phase 3).
template <bool Apply>
__global__ void __launch_bounds__(kThreads)
adafactor_update_kernel(const AdafactorArgs a) {
    const AdafactorLeaf* Lp;
    const Tile t = tile_of(a, Lp);
    const AdafactorLeaf L = *Lp;
    const float* __restrict__ g = a.g[t.leaf];
    const bool factored = L.col != nullptr;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t r0 = t.rt * kTileRows + warp, c0 = t.ct * kTileCols + lane;

    float gv[kRowsPerWarp][kColsPerLane], pv[kRowsPerWarp][kColsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
            const int64_t r = r0 + i * kWarps, c = c0 + 32 * j;
            const bool in = r < L.rows && c < L.cols;
            gv[i][j] = in ? g[r * L.cols + c] : 0.0f;
            pv[i][j] = in && Apply ? L.p[r * L.cols + c] : 0.0f;
        }
    }
    float col_f[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
        const int64_t c = c0 + 32 * j;
        col_f[j] = factored && c < L.cols ? 1.0f / sqrtf(L.col[c]) : 0.0f;
    }
    const float row_mean = factored ? a.stats[L.rfac] / L.rows_all : 1.0f;
    float lr = 0.0f, scale = 1.0f;
    if (Apply) {
        lr = __fmul_rn(fmaxf(sqrtf(a.stats[L.psq] / L.n_all), kEps2), a.rel);
        scale = fmaxf(sqrtf(a.stats[L.usq] / L.n_all) / kClip, 1.0f);
    }
    float usq = 0.0f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        const int64_t r = r0 + i * kWarps;
        const float row_f = factored && r < L.rows
            ? 1.0f / sqrtf(L.row[r] / row_mean) : 0.0f;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
            const int64_t c = c0 + 32 * j;
            if (r < L.rows && c < L.cols) {
                const float f = factored ? __fmul_rn(row_f, col_f[j])
                                         : 1.0f / sqrtf(L.row[c]);
                const float u = __fmul_rn(f, gv[i][j]);
                if (Apply) {
                    L.p[r * L.cols + c] =
                        pv[i][j] - __fmul_rn(u / scale, lr);
                } else {
                    usq += __fmul_rn(u, u);
                }
            }
        }
    }
    if (Apply) return;
    usq = block_sum(usq);
    if (threadIdx.x == 0) a.scratch[L.part + t.lt] = usq;
    if (!last_tile(a.counters + t.leaf, L.n_tiles)) return;
    const float total = fold_tiles(a, L, t.leaf);
    if (threadIdx.x == 0) a.stats[L.usq] = total;
}

}  // namespace

// One phase (0 stats, 1 moments, 2 norm, 3 apply) over the leaves of
// `args` (an AdafactorArgs), on `stream`; -> cudaError_t.
extern "C" int m2m_adafactor_phase(const void* args, int phase,
                                   void* stream) {
    const AdafactorArgs a = *static_cast<const AdafactorArgs*>(args);
    if (a.n_leaves < 1 || a.n_leaves > kMaxLeaves || a.n_tiles < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (phase) {
        case 0: adafactor_stats_kernel<<<a.n_tiles, kThreads, 0, s>>>(a);
            break;
        case 1: adafactor_moments_kernel<<<a.n_leaves, kThreads, 0, s>>>(a);
            break;
        case 2: adafactor_update_kernel<false>
                    <<<a.n_tiles, kThreads, 0, s>>>(a);
            break;
        case 3: adafactor_update_kernel<true>
                    <<<a.n_tiles, kThreads, 0, s>>>(a);
            break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
