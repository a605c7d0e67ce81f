// Direct-summation N-body kernels for Hopper (sm_90a), built by nvcc into a
// shared library with a plain C interface and bound with ctypes
// (al26_tpu_torch/ops/cuda_nbody.py builds and loads it at first use).
//
// Two Pallas kernels, each with an FMA body and a matmul body:
//
//   nbody_rows     replaces al26_tpu/ops/pallas_nbody.py::_nbody_kernel: for
//                  B target rows against N source columns, with Plummer
//                  softening eps2,
//                    acc  = G sum_j m_j dx / r^3
//                    jerk = G sum_j m_j [dv / r^3 - 3 (dx.dv) dx / r^5]
//                    pot  = -G sum_j m_j / r   (optionally softened by a
//                                               separate pot_eps2)
//                  Its FMA `body` is kernel 1 (fma_sweep, KIND_ROWS), its
//                  `group_size > 0` windows kernel 1b (KIND_GROUP), its
//                  `body_mxu` kernel 1c (pair_sweep_mma).
//   nbody_predcols replaces pallas_nbody.py::_nbody_predcols_kernel: acc and
//                  jerk of K fast rows against N columns that are Hermite-
//                  predicted to offset tau from the step-start state while
//                  each tile is staged into shared memory:
//                    p = p0 + tau v0 + tau^2/2 a0 + tau^3/6 j0
//                    v = v0 + tau a0 + tau^2/2 j0
//                  tau is read from device memory, so a substep launches
//                  without reading it back to the host. The fast columns
//                  are not overridden here; the caller adds the exact
//                  source-linearity correction (integrators._fast_override_delta).
//                  Its FMA body is kernel 2 (fma_sweep, KIND_PRED), its
//                  `body_mxu` kernel 2c (pair_sweep_mma<..., PRED>).
//
// Beside them, at the end of this file, the two kernels of the
// hermite4_block fast-group substep around kernel 2c (substep_predict,
// substep_correct; ops/cuda_substep.py), which replace no Pallas kernel.
//
// One loop for every FMA body: kernels 1, 1b and 2 here and kernel 3 (the
// tree's near field, csrc/tree.cu) sweep through pair_fma.cuh. One target
// row per thread; source columns staged as packed float4 (x, y, z, m) and
// (vx, vy, vz, -) in tiles of TJ = 256, double-buffered: tile i + 1 is
// copied by cp.async while tile i is swept, one barrier a tile (kernel 2
// copies tile i + 1's raw step-start words, then predicts them to tau into
// the other buffer, as 2c does); 1 / sqrt is the SFU's rsqrt without
// rsqrtf's subnormal fix-up; the self / range / group select runs only in
// the tiles that can hold a masked pair. Kernels 1 and 2 decide that per
// warp: a tile is masked when one of the warp's row ids falls in it
// (__any_sync; the branch only has to be warp-uniform), so a contiguous
// full sweep masks 1 tile in 128 at N = 32768 and a scattered 256-row
// subset ~22 % of a warp's tiles. A split's ragged last tile sweeps only
// its own columns. A padding row (id -1) keeps every column, as the plain
// version defines it (cuda_nbody._pair_sums); masks are selects, never
// products with 0 (0 * inf = NaN).
//
// What bounds them: a pair costs ~26 FP32 operations with the jerk (50
// flops as the JAX package's cost estimates count them, 30 without) and one
// rsqrt, two with a separately softened potential, against 28 bytes a
// source column that each row block reads from L2. So kernels 1 and 2 are
// bound by FP32 issue (kernel 1's full sweep at N = 32768 with jerk and the
// raw potential 0.80 ms on an H100; its fractal virial sum at N = 409600,
// acceleration and potential, ~75 ms; kernel 2 at K = 512 against
// N = 409600 ~0.157 ms), and a potential softened apart adds the SFU's
// second rsqrt (16 a clock an SM), close to the FP32 term.
//
// Few rows: a fast group has 256-512 rows, 2-4 row blocks of TB = 128. The
// grid's second dimension splits the columns into runs of whole tiles, at
// least two a block where N allows, filling whole waves of the card's
// resident blocks (cuda_nbody.fma_plan, split_plan's rule at the variant's
// own occupancy), and each row may be swept by LANES = 1 or 4 column lanes
// (TB x LANES threads a block; lane l sweeps columns [l W, (l + 1) W) of
// each tile, W = TJ / LANES), so that 2 row blocks still keep 16 warps an
// SM resident. The lanes' sums are added in lane order.
//
// One launch a call, in a fixed order: with more than one split every block
// writes its slab of partial sums ([rows][NSUM]), fences and takes a ticket
// of a per-device zeroed counter buffer; in each group of RED_GROUP splits
// the block that takes the group's last ticket sums the group's slabs in
// split order, and the block that takes the last group ticket sums the
// groups in order, scales by G and writes the rows. The last ticket resets
// its counter, so the counters are zero between launches; the launches
// that share them must stay in one stream's order (cuda_nbody._counters).
// The order of every sum is fixed, so a repeat gives the same bits.
//
// f32 round-off: each tile's sums start from zero and are added to the
// running sums once a tile, then across lanes, then across splits, which
// keeps them within the 1e-5 (of the max) bar of the f64 result at the N
// of a large cluster; one running sum a row over all N columns does not
// (2.5e-5 at N = 131072 on an H100). d2 = dx^2 + dy^2 + dz^2 is formed
// once; r^2 = d2 + eps2 for the forces and d2 + pot_eps2 for a separately
// softened potential (the JAX form r2 - eps2 + pot_eps2 cancels in f32 when
// d2 is much smaller than eps2).
//
// eps2 = 0: the callers pass cfg.eps2 or 1e-30, and `softening=0` gives
// eps2 = 0. The SFU's rsqrt then flushes a subnormal d2 to zero, so a
// distinct pair closer than ~1e-19 pc gets inf where rsqrtf gave a huge
// finite value; a coincident pair gets inf under either.
//
// Block-diagonal group windows (kernel 1b, group_size gs > 0) replace the
// `group_size > 0` mode of the same Pallas kernel (pallas_nbody.py:121-137
// the window, :164-167 the mask, :247-248 the loop bounds). A flattened
// ensemble of B realizations of gs stars each (global id = realization *
// gs + star) is one B*gs-row sweep in which a row only feels the columns of
// its own realization: id / gs == col / gs. That is a different sum from
// the plain sweep, not a faster way to the same one.
//   * Window: each block of TB rows reduces the smallest and largest valid
//     row id among its rows (padding rows are -1) in shared memory; a
//     scattered fast-group subset may span several groups. Its columns are
//     [g_lo gs, (g_hi + 1) gs) clipped to [0, n), with
//     g_lo = min id / gs and g_hi = max id / gs. A block of padding rows
//     only has an empty window and writes zero sums.
//   * The gridDim.y column splits (cuda_nbody._splits) divide that window,
//     not [0, n), so a 64000-row sweep of 64 realizations of 1000 stars
//     does not launch blocks that find no columns; tiles start at the
//     window's start.
//   * A row of group g keeps the columns of [g gs, (g + 1) gs) in its split
//     that are not its own id (a select from the row's group range: no
//     pair divides); a padding row (id -1) keeps none. A block whose live
//     rows are all real and of one group sweeps only that group's columns,
//     so its tiles run unmasked except the one that holds its own ids and a
//     split's ragged last tile (8 x 10240: 39 of a block's 40 tiles
//     unmasked); a block that straddles groups, holds padding rows or
//     scatters over the ensemble masks every tile.
//   * The bound: B gs^2 useful pairs (one realization each), plus the
//     masked pairs of blocks whose rows straddle two groups, roughly TB/gs
//     of the work for contiguous rows; bound by FP32 issue and, with a
//     separately softened potential, close to the SFU's rate too.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/fma_turns.py, device
// only, PERF.md §6), FMA body against matmul body at each path's shape,
// ms, with the FMA body's bound:
//   kernel 1 / 1c, jerk + raw pot, n = 8192       0.096 / 0.119  (0.050)
//   kernel 1 / 1c, jerk + raw pot, N = 32768      1.34-1.39 / 1.56  (0.80)
//   kernel 1 / 1c, the virial sweep, N = 409600   93.7 / 119  (75.1)
//   kernel 2 / 2c, K = 256 against N = 32768      0.019 / 0.0225  (0.0063)
//   kernel 2 / 2c, K = 512 against N = 409600     0.251-0.253 / 0.307  (0.157)
// The long sweeps are bound by issue: ~33 instructions a pair with the
// jerk and a separate potential (N = 32768: 78 % of that rate, 59 % of
// the FP32 bound), ~14 for acceleration and potential (the virial sweep:
// 80 % of the FP32 bound); kernel 2 at K = 512 reaches 62 %. At a few
// hundred rows a launch pays ~11 us that does not shrink with the columns
// (the first tile's staging, the split sum's two ticket phases, the
// launch) beside ~8 us of sweep, so K = 256 reaches 33 %.
//
// The matmul reduction (pair_sweep_mma, launched by nbody_rows_mma_launch
// and nbody_predcols_mma_launch) replaces the `use_mxu=True` body of both
// Pallas kernels (pallas_nbody.py:209-273 `body_mxu` of _nbody_kernel,
// :632-666 that of _nbody_predcols_kernel). The per-pair reduction sums
// become two products against the column matrix
//     C8_j = (x_j, y_j, z_j, vx_j, vy_j, vz_j, 1, |x_j|^2):
//     Sw  = sum_j w_ij  C8_j,    w_ij  = m_j / r_ij^3 (masked),
//     Sws = sum_j ws_ij C8_j,    ws_ij = w_ij (dx.dv) / r_ij^2,
// and the row sums are recovered after the column loop, e.g.
// sum_j w dx = Sw[x] - x_i Sw[1], jerk = (Sw[v] - v_i Sw[1]) -
// 3 (Sws[x] - x_i Sws[1]); with eps2 >= 1e-2 and no separate pot_eps2 the
// potential rides the same product (sum m/r = sum w r^2 = Sw[7] +
// (|x_i|^2 + eps2) Sw[1] - 2 x_i.Sw[x]). Columns and rows are centred on
// the columns' mean position and velocity (a device pointer, computed by
// the wrapper; kernel 2 centres on the step-start means and shifts its
// rows by c_pos + tau c_vel), which bounds the decomposition's
// big-minus-big cancellation. A separately softened potential (pot_eps2)
// is not linear in the columns: it stays an explicit per-pair sum in each
// lane, reduced over the four lanes of a quad by shuffles in a fixed
// order.
//   * Shape: one warp per 16 target rows (8 warps, 128 rows a block),
//     mma.sync m16n8k8 with TF32 operands and f32 accumulation. Each lane
//     computes, in registers, the four elements of the 16 x 8 A fragment
//     it owns (its two rows g, g+8 against its two columns t, t+4 of an
//     8-column chunk): A = w for Sw, ws for Sws. B is the chunk's 8 x 8
//     slice of C8, staged in shared memory with the tile.
//   * What bounds it: the tensor cores take the ~13 accumulation FMAs of
//     a pair off the FP32 pipe, so what is left per pair is FP32 issue
//     (dx, d2, the softening, w, dv, dx.dv, ws: ~23 FP32 operations with
//     the jerk) and, with a separately softened potential, the SFU: two
//     rsqrt a pair at 16 a clock per SM (~0.51 ms at N = 32768 on an
//     H100 at 1.98 GHz, above the FP32 term). Kernel 2 and the other
//     variants take one rsqrt a pair and are bound by FP32 issue.
//   * 3xTF32: one TF32 product keeps ~3 digits, which the cancellation
//     above would amplify past the bar, so both operands are split hi +
//     lo and each product is lo.hi + hi.lo + hi.hi. C8 is split once per
//     staged column by a Veltkamp split (split_tf32, round to nearest).
//     The per-pair A elements are split by a mask (split_mask): hi = x
//     with its low 13 mantissa bits cleared (one LOP3 on the integer
//     pipe), lo = x - hi (one exact FSUB); the tensor core keeps lo's top
//     11 bits, an error under 2^-21 |x| (the Veltkamp split cost four
//     FP32 operations a split, two splits a pair).
//   * In-tile accumulation: the 32 chunks of a 256-column tile chain
//     their products into one tensor-core accumulator per product; it is
//     added to the running f32 sums once per tile (MMA_CHAIN). The sums
//     stay two-level as in the FMA body: tile sums, running sums, then
//     splits in order.
//   * Masks: selects, never products with 0, and only where a tile needs
//     them: the self pair in the tiles that meet the warp's row ids, the
//     range in a split's ragged last tile. The rsqrt is the SFU's without
//     rsqrtf's subnormal fix-up (its argument is d2 plus a softening of at
//     least 1e-30). With a separate potential d2 is formed once and each
//     softening added to it; without one the softening rides the
//     distance's FMA chain (no d2 - eps2 anywhere).
//   * Staging: the column tile is double-buffered in dynamic shared
//     memory (two 24 KB tiles plus the raw words): tile i + 1's raw words
//     are copied by cp.async while tile i is swept, then centred (kernel
//     2: predicted to tau), split and stored into the other buffer; one
//     barrier a tile.
//   * One launch, in a fixed order: the grid is (row blocks, column
//     splits), each split a run of whole tiles chosen by the wrapper's
//     planner (cuda_nbody.split_plan) to fill whole waves of the card's
//     resident blocks. With more than one split every block writes its
//     slab of partials (Sw, Sws, the explicit potential: 17 sums a row),
//     fences and takes a ticket; in each group of RED_GROUP splits the
//     block with the group's last ticket sums the group's slabs in split
//     order, and the block with the last group ticket sums the groups in
//     order and applies the row recovery. The last ticket resets its
//     counter, so the counters are zero between launches, and the order is
//     fixed: a repeat gives the same bits.
//   * Registers: __launch_bounds__ asks for 3 blocks of 256 threads an SM
//     (80 registers) for every variant; measured on an H100 (sm_90a,
//     CUDA 12.9's ptxas): the main path's variant (jerk + separate
//     potential) 79 registers, kernel 2's 76, the rest 72 or fewer, no
//     spills; a cap of 4 blocks (64 registers) spilled the variants
//     without the jerk.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "pair_fma.cuh"

namespace {

// the SFU's rsqrt and the cp.async helpers of the shared FMA loop
using pair_fma::rsqrt_ftz;
using pair_fma::cp_async4;
using pair_fma::cp_async_wait_all;

constexpr int TB = 128;              // rows per block
constexpr int TJ = pair_fma::TILE;   // source columns per staged tile
constexpr int NSUM = 7;              // ax ay az jx jy jz pot

// ---------------------------------------------------------------------------
// the ordered sum of a row block's column splits, inside the launch
// ---------------------------------------------------------------------------

// splits summed by one block before the final sum over the groups
constexpr int RED_GROUP = 16;

// out[e] = sum over splits k0, k0 + step, ... (< k1), in that order, of
// word e of split k's slab (a row block's [rows][NS] sums at row0 of
// partial [splits, B, NS]); this thread's words only. Each thread keeps
// its words in registers and four slabs' loads in flight (against two:
// 3-5 % off kernels 1 and 2 at 256 rows on an H100, nothing elsewhere).
template <int NS, int THREADS>
__device__ __forceinline__ void slab_sum(const float* partial, int b,
                                         int row0, int words, int k0, int k1,
                                         int step, float* out)
{
    constexpr int WORDS = (TB * NS + THREADS - 1) / THREADS;
    const int tid = threadIdx.x;
    float v[WORDS];
#pragma unroll
    for (int j = 0; j < WORDS; ++j) v[j] = 0.f;
#pragma unroll 4
    for (int k = k0; k < k1; k += step) {
        const float* slab = partial + ((size_t)k * b + row0) * NS;
#pragma unroll
        for (int j = 0; j < WORDS; ++j) {
            const int e = tid + j * THREADS;
            if (e < words) v[j] += __ldcg(slab + e);
        }
    }
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
        const int e = tid + j * THREADS;
        if (e < words) out[e] = v[j];
    }
}

// This block's ticket of a counter: true in the block that takes the
// last of `of` tickets (which then resets the counter), after a fence
// that makes the partials written before the ticket visible to it.
__device__ __forceinline__ bool last_ticket(int* counter, int of)
{
    __shared__ int s_last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        s_last = atomicAdd(counter, 1) == of - 1;
        if (s_last) *counter = 0;
    }
    __syncthreads();
    if (!s_last) return false;
    __threadfence();
    return true;
}

// The ordered sum of a row block's splits, in one launch. Every split
// writes its slab (`red`, the block's [rows][NS] sums in shared memory);
// within each group of RED_GROUP splits the block that takes the group's
// last ticket sums the group's slabs in split order into the group's first
// slab; the block that takes the last group ticket sums the group slabs in
// group order into `red`. The order is fixed, so the bits do not depend on
// which blocks finish last. counters: (groups + 1) a row block, zero
// between launches. Returns true in that one block per row block.
template <int NS, int THREADS>
__device__ bool reduce_splits(float* partial, int* counters, int b,
                              float* red, int row0, int words)
{
    const int splits = static_cast<int>(gridDim.y);
    const int groups = (splits + RED_GROUP - 1) / RED_GROUP;
    const int y = static_cast<int>(blockIdx.y);
    int* count = counters + (size_t)blockIdx.x * (groups + 1);
    float* slab = partial + ((size_t)y * b + row0) * NS;
    for (int e = threadIdx.x; e < words; e += THREADS) slab[e] = red[e];
    const int g = y / RED_GROUP;
    const int k0 = g * RED_GROUP;
    const int k1 = min(splits, k0 + RED_GROUP);
    if (!last_ticket(count + g, k1 - k0)) return false;
    if (groups == 1) {
        slab_sum<NS, THREADS>(partial, b, row0, words, 0, splits, 1, red);
        __syncthreads();
        return true;
    }
    slab_sum<NS, THREADS>(partial, b, row0, words, k0, k1, 1,
                          partial + ((size_t)k0 * b + row0) * NS);
    if (!last_ticket(count + groups, groups)) return false;
    slab_sum<NS, THREADS>(partial, b, row0, words, 0, splits, RED_GROUP,
                          red);
    __syncthreads();
    return true;
}

// ---------------------------------------------------------------------------
// kernels 1, 1b and 2: the FMA bodies, on the loop of pair_fma.cuh
// ---------------------------------------------------------------------------

constexpr int KIND_ROWS = 0;     // kernel 1: the rows against [0, n)
constexpr int KIND_GROUP = 1;    // kernel 1b: each row's own group only
constexpr int KIND_PRED = 2;     // kernel 2: columns predicted to tau

// kernel 2's raw column words, [word][TJ]: x y z m, vx vy vz, then the
// step-start acc and jerk
constexpr int PRED_WORDS = 13;

// Everything a launch needs, passed by value (kernel parameter space).
struct FmaArgs {
    const float* rows_pos;         // [B,3]
    const float* rows_vel;         // [B,3]
    const int* row_ids;            // [B] global column id, -1 = pad
    int b;
    const float* pos;              // [N,3] (step-start for KIND_PRED)
    const float* vel;              // [N,3]
    const float* acc0;             // [N,3] KIND_PRED only
    const float* jerk0;            // [N,3] KIND_PRED only
    const float* mass;             // [N]
    int n;
    int cols_per_split;            // whole tiles (KIND_ROWS, KIND_PRED)
    int gs;                        // stars per group (KIND_GROUP)
    const float* tau;              // [1] KIND_PRED only
    float eps2, pot_eps2, g;
    float* partial;                // [splits, B, NSUM]; splits > 1 only
    int* counters;                 // (groups + 1) a row block, 0 between
    float* acc;                    // [B,3]
    float* jerk;                   // [B,3]
    float* pot;                    // [B] or null
};

// One (row block, column split) of an FMA body: TB rows, each swept by
// LANES column lanes; in the block that finishes a row block's splits
// last, their sum in split order, scaled by G and stored: one launch per
// call. __launch_bounds__ asks for 32 resident warps an SM (64 registers).
template <bool WITH_JERK, bool WITH_POT, bool SEP_POT, int KIND, int LANES>
__global__ void __launch_bounds__(TB * LANES, 8 / LANES)
fma_sweep(const __grid_constant__ FmaArgs a)
{
    static_assert(KIND != KIND_GROUP || LANES == 1,
                  "the group windows sweep one lane a row");
    constexpr int NT = TB * LANES;          // threads
    constexpr int W = TJ / LANES;           // a lane's columns of a tile
    __shared__ pair_fma::Tile tiles[2];
    __shared__ float raw[KIND == KIND_PRED ? PRED_WORDS * TJ : 1];
    __shared__ int s_lo, s_hi, s_pad;       // KIND_GROUP: the rows' ids
    static_assert(LANES * TB * NSUM * sizeof(float) <= sizeof(tiles),
                  "the lanes' sums fit in the tile buffers");

    const int tid = threadIdx.x;
    const int cl = tid / TB;                // this thread's column lane
    const int row0 = blockIdx.x * TB;
    const int row = row0 + tid % TB;
    const bool live = row < a.b;
    pair_fma::Row r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int id = -1;
    if (live) {
        r.x = a.rows_pos[3 * row + 0];
        r.y = a.rows_pos[3 * row + 1];
        r.z = a.rows_pos[3 * row + 2];
        if (WITH_JERK) {
            r.vx = a.rows_vel[3 * row + 0];
            r.vy = a.rows_vel[3 * row + 1];
            r.vz = a.rows_vel[3 * row + 2];
        }
        id = a.row_ids[row];
    }
    float tau = 0.f, t2h = 0.f, t3h = 0.f;
    if (KIND == KIND_PRED) {
        tau = *a.tau;
        t2h = 0.5f * tau * tau;
        t3h = t2h * tau * (1.0f / 3.0f);
    }

    // this split's columns [c_begin, c_end)
    int c_begin = blockIdx.y * a.cols_per_split;
    int c_end = min(a.n, c_begin + a.cols_per_split);
    // KIND_GROUP: this row's columns in the split (its own group's, none
    // for padding), and whether the block's live rows are real and of one
    // group
    int g_lo = 0, g_hi = 0;
    bool uniform = false;
    if (KIND == KIND_GROUP) {
        const int gs = a.gs;
        if (tid == 0) {
            s_lo = INT_MAX;
            s_hi = -1;
            s_pad = 0;
        }
        __syncthreads();
        if (id >= 0) {
            atomicMin(&s_lo, id);
            atomicMax(&s_hi, id);
        } else if (live) {
            s_pad = 1;
        }
        __syncthreads();
        int w_lo = 0, w_hi = 0;             // empty for all-padding blocks
        if (s_hi >= 0) {
            w_lo = (s_lo / gs) * gs;
            w_hi = min(a.n, (s_hi / gs + 1) * gs);
        }
        // whole tiles per split from the window's start
        const int splits = static_cast<int>(gridDim.y);
        const int tiles_w = (w_hi - w_lo + TJ - 1) / TJ;
        const int per_split = (tiles_w + splits - 1) / splits * TJ;
        c_begin = w_lo + static_cast<int>(blockIdx.y) * per_split;
        c_end = min(w_hi, c_begin + per_split);
        if (id >= 0) {
            g_lo = max(c_begin, (id / gs) * gs);
            g_hi = min(c_end, (id / gs + 1) * gs);
        }
        uniform = s_pad == 0 && s_hi >= 0 && s_lo / gs == s_hi / gs;
    }
    const int n_tiles = c_end > c_begin ? (c_end - c_begin + TJ - 1) / TJ : 0;

    // copy tile i's columns: straight into buffer `buf`, or (KIND_PRED)
    // their raw words into `raw`, each thread its own slots; the copies
    // complete at the next cp_async_wait_all
    auto stage = [&](int i, int buf) {
        const int t0 = c_begin + i * TJ;
        const int ncols = min(TJ, c_end - t0);
        for (int k = tid; k < ncols; k += NT) {
            const int c = t0 + k;
            if constexpr (KIND == KIND_PRED) {
                float* w = raw + k;
#pragma unroll
                for (int e = 0; e < 3; ++e) {
                    cp_async4(w + e * TJ, a.pos + 3 * c + e);
                    cp_async4(w + (4 + e) * TJ, a.vel + 3 * c + e);
                    cp_async4(w + (7 + e) * TJ, a.acc0 + 3 * c + e);
                    cp_async4(w + (10 + e) * TJ, a.jerk0 + 3 * c + e);
                }
                cp_async4(w + 3 * TJ, a.mass + c);
            } else {
                pair_fma::stage_column_async<WITH_JERK>(tiles[buf], k, a.pos,
                                                        a.vel, a.mass, c);
            }
        }
    };
    // KIND_PRED: tile i's raw words (this thread's slots) predicted to tau
    // into buffer `buf` (cuda_nbody.predict_columns' coefficient forms)
    auto predict = [&](int i, int buf) {
        const int ncols = min(TJ, c_end - (c_begin + i * TJ));
        for (int k = tid; k < ncols; k += NT) {
            const float* w = raw + k;
            const float vx = w[4 * TJ], vy = w[5 * TJ], vz = w[6 * TJ];
            const float ax0 = w[7 * TJ], ay0 = w[8 * TJ], az0 = w[9 * TJ];
            const float jx0 = w[10 * TJ], jy0 = w[11 * TJ];
            const float jz0 = w[12 * TJ];
            tiles[buf].pm[k] = make_float4(
                w[0] + tau * vx + t2h * ax0 + t3h * jx0,
                w[TJ] + tau * vy + t2h * ay0 + t3h * jy0,
                w[2 * TJ] + tau * vz + t2h * az0 + t3h * jz0, w[3 * TJ]);
            tiles[buf].v[k] = make_float4(vx + tau * ax0 + t2h * jx0,
                                          vy + tau * ay0 + t2h * jy0,
                                          vz + tau * az0 + t2h * jz0, 0.f);
        }
    };

    // double buffer: tile i + 1 is copied while tile i is swept, one
    // barrier a tile
    pair_fma::Sums s = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (n_tiles > 0) {
        stage(0, 0);
        cp_async_wait_all();
        if constexpr (KIND == KIND_PRED) predict(0, 0);
        __syncthreads();
    }
    for (int i = 0; i < n_tiles; ++i) {
        const bool more = i + 1 < n_tiles;
        if (more) stage(i + 1, (i + 1) & 1);
        const int t0 = c_begin + i * TJ;
        const int ncols = min(TJ, c_end - t0);
        const pair_fma::Tile& tile = tiles[i & 1];
        if constexpr (KIND == KIND_GROUP) {
            if (uniform && ncols == TJ && (t0 > s_hi || t0 + TJ <= s_lo))
                pair_fma::sweep_tile<WITH_JERK, WITH_POT, SEP_POT, false>(
                    tile, TJ, r, 0, TJ, -1, a.eps2, a.pot_eps2, s);
            else
                pair_fma::sweep_tile<WITH_JERK, WITH_POT, SEP_POT, true>(
                    tile, ncols, r, g_lo - t0, g_hi - t0, id - t0, a.eps2,
                    a.pot_eps2, s);
        } else {
            // this lane's columns; the self-pair mask only where one of
            // the warp's row ids falls in them (a warp-uniform branch)
            const int k0 = cl * W;
            const int k1 = min(k0 + W, ncols);
            const bool self = __any_sync(0xffffffffu,
                                         id >= t0 + k0 && id < t0 + k1);
            if (!self && ncols == TJ)
                pair_fma::sweep_span<WITH_JERK, WITH_POT, SEP_POT, false>(
                    tile, k0, k0 + W, r, 0, 0, -1, a.eps2, a.pot_eps2, s);
            else if (k0 < k1)
                pair_fma::sweep_span<WITH_JERK, WITH_POT, SEP_POT, true>(
                    tile, k0, k1, r, k0, k1, id - t0, a.eps2, a.pot_eps2,
                    s);
        }
        if (more) {
            cp_async_wait_all();        // tile i + 1 has landed
            if constexpr (KIND == KIND_PRED) predict(i + 1, (i + 1) & 1);
        }
        __syncthreads();
    }

    // the block's sums, [TB][NSUM] a lane, in the tile buffers (free after
    // the loop's last barrier); the lanes added in lane order into lane 0's
    float* red = reinterpret_cast<float*>(tiles);
    float* mine = red + (cl * TB + tid % TB) * NSUM;
    mine[0] = s.ax; mine[1] = s.ay; mine[2] = s.az;
    mine[3] = s.jx; mine[4] = s.jy; mine[5] = s.jz;
    mine[6] = s.pot;
    __syncthreads();
    if (LANES > 1) {
        if (tid < TB) {
#pragma unroll
            for (int e = 0; e < NSUM; ++e) {
                float v = mine[e];
#pragma unroll
                for (int l = 1; l < LANES; ++l) v += mine[l * TB * NSUM + e];
                mine[e] = v;
            }
        }
        __syncthreads();
    }
    const int rows = min(TB, a.b - row0);
    if (gridDim.y > 1 && !reduce_splits<NSUM, NT>(a.partial, a.counters, a.b,
                                                  red, row0, rows * NSUM))
        return;
    if (tid < rows) {
        const float* v = red + tid * NSUM;
        const int rr = row0 + tid;
        a.acc[3 * rr + 0] = a.g * v[0];
        a.acc[3 * rr + 1] = a.g * v[1];
        a.acc[3 * rr + 2] = a.g * v[2];
        a.jerk[3 * rr + 0] = WITH_JERK ? a.g * v[3] : 0.f;
        a.jerk[3 * rr + 1] = WITH_JERK ? a.g * v[4] : 0.f;
        a.jerk[3 * rr + 2] = WITH_JERK ? a.g * v[5] : 0.f;
        if (a.pot != nullptr) a.pot[rr] = WITH_POT ? a.g * v[6] : 0.f;
    }
}

// One FMA variant's launch, or (blocks_per_sm != null) its occupancy.
template <bool WITH_JERK, bool WITH_POT, bool SEP_POT, int KIND, int LANES>
int fma_variant(const FmaArgs& a, dim3 grid, cudaStream_t st,
                int* blocks_per_sm)
{
    auto kernel = fma_sweep<WITH_JERK, WITH_POT, SEP_POT, KIND, LANES>;
    if (blocks_per_sm != nullptr)
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, kernel, TB * LANES, 0));
    kernel<<<grid, TB * LANES, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// The variant of `lanes` column lanes (1 or 4).
template <bool WITH_JERK, bool WITH_POT, bool SEP_POT, int KIND>
int fma_lanes(int lanes, const FmaArgs& a, dim3 grid, cudaStream_t st,
              int* blocks_per_sm)
{
    switch (lanes) {
        case 1:
            return fma_variant<WITH_JERK, WITH_POT, SEP_POT, KIND, 1>(
                a, grid, st, blocks_per_sm);
        case 4:
            return fma_variant<WITH_JERK, WITH_POT, SEP_POT, KIND, 4>(
                a, grid, st, blocks_per_sm);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

int fma_dispatch(int with_jerk, int with_pot, int sep_pot, int kind,
                 int lanes, const FmaArgs& a, dim3 grid, cudaStream_t st,
                 int* blocks_per_sm)
{
    if (kind == KIND_PRED)   // kernel 2: jerk, no potential
        return fma_lanes<true, false, false, KIND_PRED>(lanes, a, grid, st,
                                                        blocks_per_sm);
    if (kind == KIND_GROUP && lanes != 1)
        return static_cast<int>(cudaErrorInvalidValue);
#define AL26_FMA(J, P, S)                                                   \
    (kind == KIND_GROUP                                                     \
         ? fma_variant<J, P, S, KIND_GROUP, 1>(a, grid, st, blocks_per_sm)  \
         : fma_lanes<J, P, S, KIND_ROWS>(lanes, a, grid, st, blocks_per_sm))
    if (with_jerk) {
        if (!with_pot) return AL26_FMA(true, false, false);
        if (sep_pot) return AL26_FMA(true, true, true);
        return AL26_FMA(true, true, false);
    }
    if (!with_pot) return AL26_FMA(false, false, false);
    if (sep_pot) return AL26_FMA(false, true, true);
    return AL26_FMA(false, true, false);
#undef AL26_FMA
}

// ---------------------------------------------------------------------------
// the matmul reduction (use_mxu=True)
// ---------------------------------------------------------------------------

constexpr int MW = 8;              // warps per block
constexpr int MT = 32 * MW;        // threads per block: one staged column each
constexpr int MROWS = 16 * MW;     // rows per block (16 per warp)
constexpr int NS_MMA = 17;         // Sw[8], Sws[8], explicit potential
// 8-column chunks chained into one tensor-core accumulator before it is
// added to the f32 running sums: a whole tile
constexpr int MMA_CHAIN = TJ / 8;
static_assert(MT == TJ, "one staged column per thread");
static_assert(MROWS == TB, "the wrapper's row blocks assume TB rows");
static_assert((TJ / 8) % MMA_CHAIN == 0, "whole chains per tile");

// potential modes of the matmul sweep
constexpr int POT_NONE = 0;        // not asked for
constexpr int POT_EXPLICIT = 1;    // -sum m/r at eps2 (eps2 < 1e-2)
constexpr int POT_SEPARATE = 2;    // -sum m/r at pot_eps2
constexpr int POT_PRODUCT = 3;     // through Sw (eps2 >= 1e-2)

// One staged column tile: centred (x, y, z, m) and (vx, vy, vz), and C8's
// rows split into TF32 high and low parts, as the B fragments read them.
struct MmaTile {
    float4 pm[TJ];
    float4 v[TJ];
    unsigned bhi[TJ * 8];
    unsigned blo[TJ * 8];
};

// Raw column words copied by cp.async ahead of staging, [word][TJ]:
// x y z m, then vx vy vz, then (PRED) ax0 ay0 az0 jx0 jy0 jz0.
template <bool WITH_JERK, bool PRED>
constexpr int raw_words() { return 4 + (WITH_JERK ? 3 : 0) + (PRED ? 6 : 0); }

// dynamic shared memory: two tiles (double buffer) and the raw words
template <bool WITH_JERK, bool PRED>
constexpr int mma_smem()
{
    return static_cast<int>(2 * sizeof(MmaTile)
                            + raw_words<WITH_JERK, PRED>() * TJ
                              * sizeof(float));
}

// blocks per SM that __launch_bounds__ asks registers for: 3, i.e. 80
// registers a thread, which every variant fits without a spill (4 blocks,
// 64 registers, spilled the variants without the jerk)
constexpr int MMA_MIN_BLOCKS = 3;

// Everything a launch needs, passed by value (kernel parameter space).
struct MmaArgs {
    const float* rows_pos;         // [B,3]
    const float* rows_vel;         // [B,3]
    const int* row_ids;            // [B] global column id, -1 = pad
    int b;
    const float* pos;              // [N,3] (step-start if PRED)
    const float* vel;              // [N,3]
    const float* acc0;             // [N,3] PRED only
    const float* jerk0;            // [N,3] PRED only
    const float* mass;             // [N]
    int n;
    int cols_per_split;            // whole tiles
    const float* centre;           // [6] mean pos, mean vel of the columns
    const float* tau;              // [1] PRED only
    float eps2, pot_eps2, g;
    float* partial;                // [splits, B, NS_MMA]; splits > 1 only
    int* counters;                 // [row blocks], 0 between launches
    float* acc;                    // [B,3]
    float* jerk;                   // [B,3]
    float* pot;                    // [B] or null
};

// x = hi + lo exactly, hi with 11 significant bits (a TF32 value) and lo
// with at most 12: the 3xTF32 split of a C8 element, as a Veltkamp split
// in four FP32 operations, rounding hi to nearest (once per staged column,
// so its cost does not matter). The _rn intrinsics keep the compiler from
// fusing them into an FMA, which would break the split.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo)
{
    const float c = __fmul_rn(x, 8193.0f);        // 2^13 + 1
    const float h = __fsub_rn(c, __fsub_rn(c, x));
    hi = __float_as_uint(h);
    lo = __float_as_uint(__fsub_rn(x, h));
}

// The split of a per-pair A element: hi = x with its low 13 mantissa bits
// cleared (one LOP3 on the integer pipe, a TF32 value), lo = x - hi (one
// exact FSUB, at most 13 significant bits). The tensor core keeps lo's
// top 11 bits: an error under 2^-21 |x|.
__device__ __forceinline__ void split_mask(float x, unsigned& hi,
                                           unsigned& lo)
{
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += A (16 x 8, row) . B (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += lo.hi + hi.lo + hi.hi (the small terms first)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4],
                                           unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1)
{
    mma_tf32(d, alo, bh0, bh1);
    mma_tf32(d, ahi, bl0, bl1);
    mma_tf32(d, ahi, bh0, bh1);
}


// Copy column c's raw words into this thread's slot k of `raw` (nothing
// past c_end); the copy completes at the next cp_async_wait_all.
template <bool WITH_JERK, bool PRED>
__device__ __forceinline__ void fetch_column(float* raw, int k, int c,
                                             int c_end, const MmaArgs& a)
{
    if (c >= c_end) return;
#pragma unroll
    for (int i = 0; i < 3; ++i) cp_async4(raw + i * TJ + k, a.pos + 3 * c + i);
    cp_async4(raw + 3 * TJ + k, a.mass + c);
    if (WITH_JERK) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
            cp_async4(raw + (4 + i) * TJ + k, a.vel + 3 * c + i);
    }
    if (PRED) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            cp_async4(raw + (7 + i) * TJ + k, a.acc0 + 3 * c + i);
            cp_async4(raw + (10 + i) * TJ + k, a.jerk0 + 3 * c + i);
        }
    }
}

// The column centre and kernel 2's prediction coefficients.
struct MmaFrame {
    float cpx, cpy, cpz, cvx, cvy, cvz;
    float tau, t2h, t3h;
};

// Stage slot k of a tile from its raw words: centred (and for PRED
// predicted to tau) position, velocity and mass, C8 split hi / lo; zeros
// for a column past the split's end.
template <bool WITH_JERK, bool PRED>
__device__ __forceinline__ void stage_column(MmaTile& t, const float* raw,
                                             int k, bool in,
                                             const MmaFrame& f)
{
    float px = 0.f, py = 0.f, pz = 0.f;
    float qx = 0.f, qy = 0.f, qz = 0.f, m = 0.f, one = 0.f;
    if (in) {
        px = raw[0 * TJ + k] - f.cpx;
        py = raw[1 * TJ + k] - f.cpy;
        pz = raw[2 * TJ + k] - f.cpz;
        m = raw[3 * TJ + k];
        if (WITH_JERK) {
            qx = raw[4 * TJ + k] - f.cvx;
            qy = raw[5 * TJ + k] - f.cvy;
            qz = raw[6 * TJ + k] - f.cvz;
        }
        if (PRED) {
            const float ax0 = raw[7 * TJ + k], ay0 = raw[8 * TJ + k];
            const float az0 = raw[9 * TJ + k], jx0 = raw[10 * TJ + k];
            const float jy0 = raw[11 * TJ + k], jz0 = raw[12 * TJ + k];
            px = px + f.tau * qx + f.t2h * ax0 + f.t3h * jx0;
            py = py + f.tau * qy + f.t2h * ay0 + f.t3h * jy0;
            pz = pz + f.tau * qz + f.t2h * az0 + f.t3h * jz0;
            qx = qx + f.tau * ax0 + f.t2h * jx0;
            qy = qy + f.tau * ay0 + f.t2h * jy0;
            qz = qz + f.tau * az0 + f.t2h * jz0;
        }
        one = 1.f;
    }
    t.pm[k] = make_float4(px, py, pz, m);
    t.v[k] = make_float4(qx, qy, qz, 0.f);
    const float c8[8] = {px, py, pz, qx, qy, qz, one,
                         px * px + py * py + pz * pz};
#pragma unroll
    for (int e = 0; e < 8; ++e)
        split_tf32(c8[e], t.bhi[8 * k + e], t.blo[8 * k + e]);
}

// This lane's two rows (gq and gq + 8 of its warp's 16), centred.
struct MmaRows {
    float x[2], y[2], z[2], vx[2], vy[2], vz[2];
    int id[2];
};

// the masks a tile needs: none, the self pair (a tile that holds one of
// the warp's row ids), or the self pair and the range (a split's ragged
// last tile)
constexpr int MASK_NONE = 0;
constexpr int MASK_SELF = 1;
constexpr int MASK_RANGE = 2;

// One tile against this lane's rows: per 8-column chunk the lane forms its
// four A elements (w and, with the jerk, w s) in registers and issues
// 3xTF32 products against the chunk's C8 slice; MMA_CHAIN chunks chain
// into one accumulator, which is then added to the running f32 sums. The
// explicit potential is a per-tile f32 sum. Masks are selects, never
// products with 0, and only where the tile needs them (MASK).
template <bool WITH_JERK, int POT, int MASK>
__device__ __forceinline__ void sweep_tile(const MmaTile& t, int t0,
                                           int c_end, int gq, int tq,
                                           const MmaRows& r, float eps2,
                                           float pot_eps2, float (&sw)[4],
                                           float (&ss)[4], float (&pot)[2])
{
    float tp[2] = {0.f, 0.f};
    for (int g0 = 0; g0 < TJ; g0 += 8 * MMA_CHAIN) {
        float tw[4] = {0.f, 0.f, 0.f, 0.f};
        float ts[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int k0 = g0; k0 < g0 + 8 * MMA_CHAIN; k0 += 8) {
            // A fragments: element q + 2 cc is (row gq + 8 q, col tq + 4 cc)
            unsigned awh[4], awl[4], ash[4], asl[4];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
                const int kc = k0 + tq + 4 * cc;
                const int col = t0 + kc;
                const float4 pm = t.pm[kc];
                float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
                if (WITH_JERK) vv = t.v[kc];
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int e = q + 2 * cc;
                    const float dx = pm.x - r.x[q];
                    const float dy = pm.y - r.y[q];
                    const float dz = pm.z - r.z[q];
                    // d2 alone only for a separately softened potential;
                    // else the softening rides the distance's FMA chain
                    float d2 = 0.f, r2;
                    if (POT == POT_SEPARATE) {
                        d2 = dx * dx + dy * dy + dz * dz;
                        r2 = d2 + eps2;
                    } else {
                        r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
                    }
                    bool valid = true;
                    if (MASK != MASK_NONE) valid = col != r.id[q];
                    if (MASK == MASK_RANGE) valid = valid && col < c_end;
                    float inv_r = rsqrt_ftz(r2);
                    if (MASK != MASK_NONE) inv_r = valid ? inv_r : 0.f;
                    const float inv_r2 = inv_r * inv_r;
                    const float w = pm.w * (inv_r * inv_r2);
                    split_mask(w, awh[e], awl[e]);
                    if (WITH_JERK) {
                        const float dvx = vv.x - r.vx[q];
                        const float dvy = vv.y - r.vy[q];
                        const float dvz = vv.z - r.vz[q];
                        const float s = (dx * dvx + dy * dvy + dz * dvz)
                                        * inv_r2;
                        split_mask(w * s, ash[e], asl[e]);
                    }
                    if (POT == POT_EXPLICIT) {
                        tp[q] -= pm.w * inv_r;
                    } else if (POT == POT_SEPARATE) {
                        float inv_rp = rsqrt_ftz(d2 + pot_eps2);
                        if (MASK != MASK_NONE) inv_rp = valid ? inv_rp : 0.f;
                        tp[q] -= pm.w * inv_rp;
                    }
                }
            }
            // B fragment: C8[k0 + tq][gq] and C8[k0 + tq + 4][gq]
            const unsigned bh0 = t.bhi[8 * (k0 + tq) + gq];
            const unsigned bh1 = t.bhi[8 * (k0 + tq + 4) + gq];
            const unsigned bl0 = t.blo[8 * (k0 + tq) + gq];
            const unsigned bl1 = t.blo[8 * (k0 + tq + 4) + gq];
            mma_3xtf32(tw, awh, awl, bh0, bh1, bl0, bl1);
            if (WITH_JERK) mma_3xtf32(ts, ash, asl, bh0, bh1, bl0, bl1);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            sw[i] += tw[i];
            ss[i] += ts[i];
        }
    }
    pot[0] += tp[0];
    pot[1] += tp[1];
}

// Recover one row's sums from Sw / Sws and the explicit potential
// (pallas_nbody.py:256-273, :659-666), scale by G and store them.
template <bool WITH_JERK, int POT>
__device__ __forceinline__ void recover_row(const float* s, int row,
                                            const MmaArgs& a, float shx,
                                            float shy, float shz,
                                            const MmaFrame& f)
{
    // the same centred row the sweep used
    const float xi = a.rows_pos[3 * row + 0] - shx;
    const float yi = a.rows_pos[3 * row + 1] - shy;
    const float zi = a.rows_pos[3 * row + 2] - shz;
    const float sw1 = s[6];
    const float ax = s[0] - xi * sw1;
    const float ay = s[1] - yi * sw1;
    const float az = s[2] - zi * sw1;
    a.acc[3 * row + 0] = a.g * ax;
    a.acc[3 * row + 1] = a.g * ay;
    a.acc[3 * row + 2] = a.g * az;
    float jx = 0.f, jy = 0.f, jz = 0.f;
    if (WITH_JERK) {
        const float vxi = a.rows_vel[3 * row + 0] - f.cvx;
        const float vyi = a.rows_vel[3 * row + 1] - f.cvy;
        const float vzi = a.rows_vel[3 * row + 2] - f.cvz;
        const float sws1 = s[14];
        // the jerk's factor 3 once per row, not once per pair
        jx = (s[3] - vxi * sw1) - 3.0f * (s[8] - xi * sws1);
        jy = (s[4] - vyi * sw1) - 3.0f * (s[9] - yi * sws1);
        jz = (s[5] - vzi * sw1) - 3.0f * (s[10] - zi * sws1);
    }
    a.jerk[3 * row + 0] = a.g * jx;
    a.jerk[3 * row + 1] = a.g * jy;
    a.jerk[3 * row + 2] = a.g * jz;
    if (a.pot != nullptr) {
        float p = 0.f;
        if (POT == POT_PRODUCT) {
            // sum w r^2 = S7 - 2 x_i.a - |x_i|^2 sw1 + eps2 sw1
            const float xi2 = xi * xi + yi * yi + zi * zi;
            p = -(s[7] + (a.eps2 - xi2) * sw1
                  - 2.0f * (xi * ax + yi * ay + zi * az));
        } else if (POT != POT_NONE) {
            p = s[16];
        }
        a.pot[row] = a.g * p;
    }
}


// The sweep of one (row block, column split) and, in the block that
// finishes a row block's splits last, their sum in split order and the
// row recovery: one launch per call.
template <bool WITH_JERK, int POT, bool PRED>
__global__ void __launch_bounds__(MT, MMA_MIN_BLOCKS)
pair_sweep_mma(const __grid_constant__ MmaArgs a)
{
    extern __shared__ float4 mma_smem_f4[];
    MmaTile* tiles = reinterpret_cast<MmaTile*>(mma_smem_f4);
    float* raw = reinterpret_cast<float*>(tiles + 2);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gq = lane >> 2;              // fragment row group
    const int tq = lane & 3;               // thread in the group

    MmaFrame f;
    f.cpx = a.centre[0]; f.cpy = a.centre[1]; f.cpz = a.centre[2];
    f.cvx = a.centre[3]; f.cvy = a.centre[4]; f.cvz = a.centre[5];
    f.tau = f.t2h = f.t3h = 0.f;
    if (PRED) {
        f.tau = *a.tau;
        f.t2h = 0.5f * f.tau * f.tau;
        f.t3h = f.t2h * f.tau * (1.0f / 3.0f);
    }
    // the rows' shift: the columns' centre, drifted to tau for PRED
    const float shx = PRED ? f.cpx + f.tau * f.cvx : f.cpx;
    const float shy = PRED ? f.cpy + f.tau * f.cvy : f.cpy;
    const float shz = PRED ? f.cpz + f.tau * f.cvz : f.cpz;

    const int row0 = blockIdx.x * MROWS;
    MmaRows r;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int row = row0 + warp * 16 + gq + 8 * q;
        r.x[q] = r.y[q] = r.z[q] = r.vx[q] = r.vy[q] = r.vz[q] = 0.f;
        r.id[q] = -1;
        if (row < a.b) {
            r.x[q] = a.rows_pos[3 * row + 0] - shx;
            r.y[q] = a.rows_pos[3 * row + 1] - shy;
            r.z[q] = a.rows_pos[3 * row + 2] - shz;
            if (WITH_JERK) {
                r.vx[q] = a.rows_vel[3 * row + 0] - f.cvx;
                r.vy[q] = a.rows_vel[3 * row + 1] - f.cvy;
                r.vz[q] = a.rows_vel[3 * row + 2] - f.cvz;
            }
            r.id[q] = a.row_ids[row];
        }
    }

    // the warp's row ids span [id_lo, id_hi] (padding ids excluded): only
    // the tiles that meet it need the self-pair mask
    const int id_lo = __reduce_min_sync(
        0xffffffffu, min(r.id[0] < 0 ? INT_MAX : r.id[0],
                         r.id[1] < 0 ? INT_MAX : r.id[1]));
    const int id_hi = __reduce_max_sync(0xffffffffu, max(r.id[0], r.id[1]));

    const int c_begin = blockIdx.y * a.cols_per_split;
    const int c_end = min(a.n, c_begin + a.cols_per_split);
    const int n_tiles = (c_end - c_begin + TJ - 1) / TJ;
    float sw[4] = {0.f, 0.f, 0.f, 0.f};    // running Sw fragment
    float ss[4] = {0.f, 0.f, 0.f, 0.f};    // running Sws fragment
    float pot[2] = {0.f, 0.f};             // explicit potential, rows gq, gq+8

    // double buffer: tile i + 1's raw words are copied (cp.async) while
    // tile i is swept, then staged into the other buffer; one barrier a
    // tile
    fetch_column<WITH_JERK, PRED>(raw, tid, c_begin + tid, c_end, a);
    cp_async_wait_all();
    stage_column<WITH_JERK, PRED>(tiles[0], raw, tid, c_begin + tid < c_end,
                                  f);
    __syncthreads();
    for (int i = 0; i < n_tiles; ++i) {
        const int t0 = c_begin + i * TJ;
        const bool more = i + 1 < n_tiles;
        if (more)
            fetch_column<WITH_JERK, PRED>(raw, tid, t0 + TJ + tid, c_end, a);
        const MmaTile& t = tiles[i & 1];
        if (t0 + TJ > c_end)
            sweep_tile<WITH_JERK, POT, MASK_RANGE>(t, t0, c_end, gq, tq, r,
                                                   a.eps2, a.pot_eps2, sw,
                                                   ss, pot);
        else if (id_lo < t0 + TJ && id_hi >= t0)
            sweep_tile<WITH_JERK, POT, MASK_SELF>(t, t0, c_end, gq, tq, r,
                                                  a.eps2, a.pot_eps2, sw, ss,
                                                  pot);
        else
            sweep_tile<WITH_JERK, POT, MASK_NONE>(t, t0, c_end, gq, tq, r,
                                                  a.eps2, a.pot_eps2, sw, ss,
                                                  pot);
        if (more) {
            cp_async_wait_all();
            stage_column<WITH_JERK, PRED>(tiles[(i + 1) & 1], raw, tid,
                                          t0 + TJ + tid < c_end, f);
        }
        __syncthreads();
    }

    // the explicit potential: sum over the quad's four lanes (their
    // columns), in a fixed order
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        pot[q] += __shfl_xor_sync(0xffffffffu, pot[q], 1);
        pot[q] += __shfl_xor_sync(0xffffffffu, pot[q], 2);
    }
    // the block's sums, [MROWS][NS_MMA], in the tile buffers (free after
    // the loop's last barrier). Accumulator fragment: (row gq, cols 2tq,
    // 2tq+1) in [0], [1], row gq + 8 in [2], [3]
    float* red = reinterpret_cast<float*>(mma_smem_f4);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        float* s = red + (warp * 16 + gq + 8 * q) * NS_MMA;
        s[2 * tq + 0] = sw[2 * q + 0];
        s[2 * tq + 1] = sw[2 * q + 1];
        s[8 + 2 * tq + 0] = WITH_JERK ? ss[2 * q + 0] : 0.f;
        s[8 + 2 * tq + 1] = WITH_JERK ? ss[2 * q + 1] : 0.f;
        if (tq == 0)
            s[16] = (POT == POT_EXPLICIT || POT == POT_SEPARATE) ? pot[q]
                                                                 : 0.f;
    }
    __syncthreads();
    const int rows = min(MROWS, a.b - row0);
    if (gridDim.y > 1
        && !reduce_splits<NS_MMA, MT>(a.partial, a.counters, a.b, red, row0,
                                      rows * NS_MMA))
        return;
    if (tid < rows)
        recover_row<WITH_JERK, POT>(red + tid * NS_MMA, row0 + tid, a, shx,
                                    shy, shz, f);
}

// One variant's launch, or (blocks_per_sm != null) its occupancy. The
// dynamic shared memory above 48 KB is allowed once per process.
template <bool WITH_JERK, int POT, bool PRED>
int mma_variant(const MmaArgs& a, dim3 grid, cudaStream_t st,
                int* blocks_per_sm)
{
    auto kernel = pair_sweep_mma<WITH_JERK, POT, PRED>;
    constexpr int smem = mma_smem<WITH_JERK, PRED>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (blocks_per_sm != nullptr)
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, kernel, MT, smem));
    kernel<<<grid, MT, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}

int mma_dispatch(int with_jerk, int pot_mode, int pred, const MmaArgs& a,
                 dim3 grid, cudaStream_t st, int* blocks_per_sm)
{
    if (pred)   // kernel 2: jerk, no potential
        return mma_variant<true, POT_NONE, true>(a, grid, st, blocks_per_sm);
#define AL26_MMA(J, P) mma_variant<J, P, false>(a, grid, st, blocks_per_sm)
    if (with_jerk) {
        switch (pot_mode) {
            case POT_EXPLICIT: return AL26_MMA(true, POT_EXPLICIT);
            case POT_SEPARATE: return AL26_MMA(true, POT_SEPARATE);
            case POT_PRODUCT: return AL26_MMA(true, POT_PRODUCT);
            default: return AL26_MMA(true, POT_NONE);
        }
    }
    switch (pot_mode) {
        case POT_EXPLICIT: return AL26_MMA(false, POT_EXPLICIT);
        case POT_SEPARATE: return AL26_MMA(false, POT_SEPARATE);
        case POT_PRODUCT: return AL26_MMA(false, POT_PRODUCT);
        default: return AL26_MMA(false, POT_NONE);
    }
#undef AL26_MMA
}

// ---------------------------------------------------------------------------
// the hermite4_block fast-group substep around kernel 2c
// ---------------------------------------------------------------------------
//
// These two kernels replace no Pallas kernel: the JAX package runs the
// two-tier predicted-columns substep (al26_tpu/ops/integrators.py,
// hermite4_block_advance) as jnp inside lax.while_loop, where XLA fuses it.
// Run eagerly, the same substep is ~110 small torch launches beside kernel
// 2c, and the host's time to issue them, not the device, sets the
// substep's pace. These kernels exist to take those launches down to two:
//   substep_predict  one block: h = eta sqrt(min_i |a_i|^2 / max(|j_i|^2,
//                    1e-30)) over the K fast rows (a block-wide min),
//                    clamped to [h_min, dt - tau]; th = tau + h, the f32
//                    offset kernel 2c reads from device memory; the fast
//                    rows' predictor over h, (pfp, vfp), kernel 2c's rows;
//                    and the fast columns' step-start prediction to th,
//                    (pf_pred, vf_pred);
//   (kernel 2c, launched by the caller through cuda_nbody.PredcolsMma)
//   substep_correct  blocks of SUB_ROWS rows: the exact fast-column
//                    override (integrators._fast_override_delta: two K x K
//                    pair sums, self pair masked, against (pfp, vfp) and
//                    against (pf_pred, vf_pred), g (a_s - a_p) and
//                    g (j_s - j_p)) added to 2c's (a1, j1); the Hermite
//                    corrector; the fast rows' state updated in place;
//                    tau = th and the flag th < dt that the loop's one host
//                    read takes.
// What bounds them: launch latency. 2 K^2 pairs at K = 512 are ~24 MFLOP,
// ~0.4 us of the card's FP32 rate, and the rows' state is ~50 KB. So the
// correct kernel spreads a row's K columns over SUB_LANES lanes (K = 512:
// 64 blocks of 128 threads, 32 columns a lane and state) with the columns
// staged once a block in shared memory, and the step size needs one block.
//
// Arithmetic: the state's f32, products in full precision (no TF32, no fast
// math). The step size, the predictors and the corrector round each
// product and sum apart (__fmul_rn, __fadd_rn), in the torch loop's order,
// with torch's a * (1 / c) for a division by a constant. The delta's column
// sums are split over the lanes and reduced by shuffles in a fixed order,
// so they differ from torch's einsum only in rounding order, and a repeat
// gives the same bits. 1 / r is rsqrtf, as torch.rsqrt. A NaN criterion
// propagates into h and tau as torch.min, maximum and minimum propagate it,
// so a poisoned force ends the loop as the torch loop ends.

constexpr int SUB_PRED_THREADS = 1024;   // substep_predict: at most, one block
constexpr int SUB_ROWS = 8;              // substep_correct: rows a block
constexpr int SUB_LANES = 16;            // column lanes a row
constexpr int SUB_TILE = 512;            // fast columns staged a tile

// [4, K, 3] fast-row arrays: p, v, a, j (state) or pfp, vfp, pf_pred,
// vf_pred (the substep's predictions)
struct SubArgs {
    const float* s0;        // the step-start fast rows
    float* s;               // the subcycled fast rows, updated in place
    float* w;               // the substep's predictions
    float* sc;              // tau, h, th, flag
    const float* dt;
    const float* h_min;
    const float* eps2_ptr;  // eps2 from device memory, or null: `eps2`
    const float* mass;      // [K] the fast rows' masses
    const float* a1;        // [K, 3] kernel 2c's acc and jerk
    const float* j1;
    float eta, eps2, g;
    int k;
};

// NaN-propagating min and max, as torch.min / minimum / maximum / clamp
__device__ __forceinline__ float nan_min(float a, float b)
{
    return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b)
{
    return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float3 ld3(const float* x, int q, int k, int i)
{
    const float* p = x + ((size_t)q * k + i) * 3;
    return make_float3(p[0], p[1], p[2]);
}

__device__ __forceinline__ void st3(float* x, int q, int k, int i, float3 v)
{
    float* p = x + ((size_t)q * k + i) * 3;
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
}

// a + c b and a - b, each product and sum rounded apart
__device__ __forceinline__ float3 add_mul(float3 a, float c, float3 b)
{
    return make_float3(__fadd_rn(a.x, __fmul_rn(c, b.x)),
                       __fadd_rn(a.y, __fmul_rn(c, b.y)),
                       __fadd_rn(a.z, __fmul_rn(c, b.z)));
}

__device__ __forceinline__ float3 sub3(float3 a, float3 b)
{
    return make_float3(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                       __fsub_rn(a.z, b.z));
}

__device__ __forceinline__ float3 add3(float3 a, float3 b)
{
    return make_float3(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z));
}

// |x|^2 as torch.sum(x * x, dim=-1) adds it on an H100: (x^2 + z^2) + y^2
__device__ __forceinline__ float norm2(float3 x)
{
    return __fadd_rn(__fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.z, x.z)),
                     __fmul_rn(x.y, x.y));
}

// Hermite predictor over t: (p + t v + (t^2 / 2) a + (t^3 / 6) j,
// v + t a + (t^2 / 2) j), in the torch loop's order
__device__ __forceinline__ void predict(float3 p, float3 v, float3 a,
                                        float3 j, float t, float3& pp,
                                        float3& vp)
{
    const float t2 = __fmul_rn(t, t);
    const float c2 = __fmul_rn(0.5f, t2);
    const float c3 = __fmul_rn(__fmul_rn(t2, t), 1.0f / 6.0f);
    pp = add_mul(add_mul(add_mul(p, t, v), c2, a), c3, j);
    vp = add_mul(add_mul(v, t, a), c2, j);
}

__global__ void __launch_bounds__(SUB_PRED_THREADS)
substep_predict(SubArgs a)
{
    __shared__ float red[SUB_PRED_THREADS / 32];
    __shared__ float h_shared;
    const int k = a.k;
    float m = CUDART_INF_F;
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
        const float a2 = norm2(ld3(a.s, 2, k, i));
        const float j2 = norm2(ld3(a.s, 3, k, i));
        m = nan_min(m, __fdiv_rn(a2, nan_max(j2, 1e-30f)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    const float tau = a.sc[0];
    if (threadIdx.x == 0) {
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
            m = nan_min(m, red[w]);
        float h = __fmul_rn(a.eta, __fsqrt_rn(m));
        h = nan_min(nan_max(h, *a.h_min), __fsub_rn(*a.dt, tau));
        h_shared = h;
        a.sc[1] = h;
        a.sc[2] = __fadd_rn(tau, h);
    }
    __syncthreads();
    const float h = h_shared;
    const float th = __fadd_rn(tau, h);
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
        float3 pp, vp;
        predict(ld3(a.s, 0, k, i), ld3(a.s, 1, k, i), ld3(a.s, 2, k, i),
                ld3(a.s, 3, k, i), h, pp, vp);
        st3(a.w, 0, k, i, pp);
        st3(a.w, 1, k, i, vp);
        predict(ld3(a.s0, 0, k, i), ld3(a.s0, 1, k, i), ld3(a.s0, 2, k, i),
                ld3(a.s0, 3, k, i), th, pp, vp);
        st3(a.w, 2, k, i, pp);
        st3(a.w, 3, k, i, vp);
    }
}

// one masked pair of the override's sums: acc += w dx, wdv += w dv,
// wsdx += w s dx with w = m / r^3, s = 3 (dx.dv) / r^2
__device__ __forceinline__ void override_pair(
    float px, float py, float pz, float vx, float vy, float vz, float m,
    float3 pr, float3 vr, float eps2, bool self, float3& acc, float3& wdv,
    float3& wsdx)
{
    const float dx = px - pr.x, dy = py - pr.y, dz = pz - pr.z;
    const float ux = vx - vr.x, uy = vy - vr.y, uz = vz - vr.z;
    const float r2 = dx * dx + dy * dy + dz * dz + eps2;
    const float inv_r = self ? 0.f : rsqrtf(r2);
    const float inv_r2 = inv_r * inv_r;
    const float w = m * (inv_r * inv_r2);
    const float ws = w * (3.f * (dx * ux + dy * uy + dz * uz) * inv_r2);
    acc.x += w * dx;
    acc.y += w * dy;
    acc.z += w * dz;
    wdv.x += w * ux;
    wdv.y += w * uy;
    wdv.z += w * uz;
    wsdx.x += ws * dx;
    wsdx.y += ws * dy;
    wsdx.z += ws * dz;
}

__device__ __forceinline__ float lane_sum(float v)
{
#pragma unroll
    for (int off = SUB_LANES / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float3 lane_sum3(float3 v)
{
    return make_float3(lane_sum(v.x), lane_sum(v.y), lane_sum(v.z));
}

__global__ void __launch_bounds__(SUB_ROWS * SUB_LANES)
substep_correct(SubArgs a)
{
    // the tile's columns: (pfp, vfp, pf_pred, vf_pred) x (x, y, z), mass
    __shared__ float col[13][SUB_TILE];
    const int k = a.k;
    const int lane = threadIdx.x % SUB_LANES;
    const int i = blockIdx.x * SUB_ROWS + threadIdx.x / SUB_LANES;
    const int row = i < k ? i : k - 1;   // rows past K: sums, no writes
    const float3 pr = ld3(a.w, 0, k, row), vr = ld3(a.w, 1, k, row);
    const float eps2 = a.eps2_ptr != nullptr ? *a.eps2_ptr : a.eps2;
    const float3 z = make_float3(0.f, 0.f, 0.f);
    float3 acc_s = z, wdv_s = z, wsdx_s = z;
    float3 acc_p = z, wdv_p = z, wsdx_p = z;
    for (int c0 = 0; c0 < k; c0 += SUB_TILE) {
        const int nc = min(SUB_TILE, k - c0);
        __syncthreads();
        for (int e = threadIdx.x; e < nc; e += blockDim.x) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float3 v = ld3(a.w, q, k, c0 + e);
                col[3 * q][e] = v.x;
                col[3 * q + 1][e] = v.y;
                col[3 * q + 2][e] = v.z;
            }
            col[12][e] = a.mass[c0 + e];
        }
        __syncthreads();
        for (int e = lane; e < nc; e += SUB_LANES) {
            const bool self = c0 + e == row;
            const float m = col[12][e];
            override_pair(col[0][e], col[1][e], col[2][e], col[3][e],
                          col[4][e], col[5][e], m, pr, vr, eps2, self, acc_s,
                          wdv_s, wsdx_s);
            override_pair(col[6][e], col[7][e], col[8][e], col[9][e],
                          col[10][e], col[11][e], m, pr, vr, eps2, self,
                          acc_p, wdv_p, wsdx_p);
        }
    }
    acc_s = lane_sum3(acc_s);
    wdv_s = lane_sum3(wdv_s);
    wsdx_s = lane_sum3(wsdx_s);
    acc_p = lane_sum3(acc_p);
    wdv_p = lane_sum3(wdv_p);
    wsdx_p = lane_sum3(wsdx_p);
    const float h = a.sc[1];
    if (lane == 0 && i < k) {
        // delta = g (a_s - a_p), g (j_s - j_p), j = wdv - wsdx
        const float3 da = sub3(acc_s, acc_p);
        const float3 dj = sub3(sub3(wdv_s, wsdx_s), sub3(wdv_p, wsdx_p));
        const float3 a1 = add_mul(ld3(a.a1, 0, k, i), a.g, da);
        const float3 j1 = add_mul(ld3(a.j1, 0, k, i), a.g, dj);
        const float3 pf = ld3(a.s, 0, k, i), vf = ld3(a.s, 1, k, i);
        const float3 af = ld3(a.s, 2, k, i), jf = ld3(a.s, 3, k, i);
        // vf1 = vf + (h / 2) (af + a1) + (h^2 / 12) (jf - j1)
        // pf1 = pf + (h / 2) (vf + vf1) + (h^2 / 12) (af - a1)
        const float hh = __fmul_rn(0.5f, h);
        const float c12 = __fmul_rn(__fmul_rn(h, h), 1.0f / 12.0f);
        const float3 vf1 = add_mul(add_mul(vf, hh, add3(af, a1)), c12,
                                   sub3(jf, j1));
        const float3 pf1 = add_mul(add_mul(pf, hh, add3(vf, vf1)), c12,
                                   sub3(af, a1));
        st3(a.s, 0, k, i, pf1);
        st3(a.s, 1, k, i, vf1);
        st3(a.s, 2, k, i, a1);
        st3(a.s, 3, k, i, j1);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        const float th = a.sc[2];
        a.sc[0] = th;
        a.sc[3] = th < *a.dt ? 1.f : 0.f;
    }
}

}  // namespace

extern "C" {

// Kernel 1 (group_size 0) or 1b (group_size > 0): `splits` column splits
// (kernel 1: of cols_per_split columns, whole tiles; kernel 1b: of each
// block's window), `lanes` column lanes a row (1 or 4; 1 for kernel 1b).
// With splits > 1, partial holds [splits, B, 7] floats and counters
// (ceil(splits / 16) + 1) zeroed ints a row block (every launch leaves
// them zero). One launch; returns its cudaGetLastError().
int nbody_rows_launch(
    const float* rows_pos, const float* rows_vel, const int* row_ids, int b,
    const float* pos, const float* vel, const float* mass, int n,
    float eps2, float pot_eps2, float g,
    int with_jerk, int with_pot, int sep_pot, int group_size,
    float* partial, int* counters, int splits, int cols_per_split, int lanes,
    float* acc, float* jerk, float* pot, void* stream)
{
    const FmaArgs a{rows_pos, rows_vel, row_ids, b, pos, vel, nullptr,
                    nullptr, mass, n, cols_per_split, group_size, nullptr,
                    eps2, pot_eps2, g, partial, counters, acc, jerk, pot};
    const dim3 grid((b + TB - 1) / TB, splits);
    return fma_dispatch(with_jerk, with_pot, sep_pot,
                        group_size > 0 ? KIND_GROUP : KIND_ROWS, lanes, a,
                        grid, static_cast<cudaStream_t>(stream), nullptr);
}

// Kernel 2: columns predicted to *tau from the step-start state. Splits,
// lanes and scratch as for kernel 1. One launch; returns its
// cudaGetLastError().
int nbody_predcols_launch(
    const float* rows_pos, const float* rows_vel, const int* row_ids, int b,
    const float* pos0, const float* vel0, const float* acc0,
    const float* jerk0, const float* mass, int n,
    const float* tau, float eps2, float g,
    float* partial, int* counters, int splits, int cols_per_split, int lanes,
    float* acc, float* jerk, void* stream)
{
    const FmaArgs a{rows_pos, rows_vel, row_ids, b, pos0, vel0, acc0, jerk0,
                    mass, n, cols_per_split, 0, tau, eps2, 0.f, g, partial,
                    counters, acc, jerk, nullptr};
    const dim3 grid((b + TB - 1) / TB, splits);
    return fma_dispatch(1, 0, 0, KIND_PRED, lanes, a, grid,
                        static_cast<cudaStream_t>(stream), nullptr);
}

// Resident blocks per SM of one FMA variant (kind 0 kernel 1, 1 kernel 1b,
// 2 kernel 2) at `lanes` column lanes, into *blocks; returns the CUDA error.
int nbody_fma_blocks_per_sm(int with_jerk, int with_pot, int sep_pot,
                            int kind, int lanes, int* blocks)
{
    const FmaArgs a{};
    return fma_dispatch(with_jerk, with_pot, sep_pot, kind, lanes, a, dim3(1),
                        nullptr, blocks);
}

// Kernel 1, matmul reduction. pot_mode: 0 none, 1 explicit at eps2, 2
// explicit at pot_eps2, 3 through the product. splits column splits of
// cols_per_split (whole tiles) each; with splits > 1, partial holds
// [splits, B, 17] floats and counters as for kernel 1. One launch;
// returns its cudaGetLastError().
int nbody_rows_mma_launch(
    const float* rows_pos, const float* rows_vel, const int* row_ids, int b,
    const float* pos, const float* vel, const float* mass, int n,
    const float* centre, float eps2, float pot_eps2, float g,
    int with_jerk, int pot_mode,
    float* partial, int* counters, int splits, int cols_per_split,
    float* acc, float* jerk, float* pot, void* stream)
{
    const MmaArgs a{rows_pos, rows_vel, row_ids, b, pos, vel, nullptr,
                    nullptr, mass, n, cols_per_split, centre, nullptr, eps2,
                    pot_eps2, g, partial, counters, acc, jerk, pot};
    const dim3 grid((b + MROWS - 1) / MROWS, splits);
    return mma_dispatch(with_jerk, pot_mode, 0, a, grid,
                        static_cast<cudaStream_t>(stream), nullptr);
}

// Kernel 2, matmul reduction: columns centred on the step-start means
// (centre), predicted to tau; rows shifted by c_pos + tau c_vel. Scratch
// as for kernel 1. One launch; returns its cudaGetLastError().
int nbody_predcols_mma_launch(
    const float* rows_pos, const float* rows_vel, const int* row_ids, int b,
    const float* pos0, const float* vel0, const float* acc0,
    const float* jerk0, const float* mass, int n,
    const float* centre, const float* tau, float eps2, float g,
    float* partial, int* counters, int splits, int cols_per_split,
    float* acc, float* jerk, void* stream)
{
    const MmaArgs a{rows_pos, rows_vel, row_ids, b, pos0, vel0, acc0, jerk0,
                    mass, n, cols_per_split, centre, tau, eps2, 0.f, g,
                    partial, counters, acc, jerk, nullptr};
    const dim3 grid((b + MROWS - 1) / MROWS, splits);
    return mma_dispatch(1, POT_NONE, 1, a, grid,
                        static_cast<cudaStream_t>(stream), nullptr);
}

// Resident blocks per SM of one matmul variant (pred: kernel 2), from its
// registers and shared memory, into *blocks; returns the CUDA error.
int nbody_mma_blocks_per_sm(int with_jerk, int pot_mode, int pred,
                            int* blocks)
{
    const MmaArgs a{};
    return mma_dispatch(with_jerk, pot_mode, pred, a, dim3(1), nullptr,
                        blocks);
}

// The substep's step size and predictions (substep_predict): reads the
// fast rows' state s and step-start rows s0 ([4, K, 3] each), tau = sc[0],
// *dt, *h_min; writes sc[1] = h, sc[2] = th and w = (pfp, vfp, pf_pred,
// vf_pred). One launch; returns its cudaGetLastError().
int substep_predict_launch(const float* s0, float* s, float* w,
                           float* sc, const float* dt, const float* h_min,
                           float eta, int k, void* stream)
{
    SubArgs a{};
    a.s0 = s0;
    a.s = s;
    a.w = w;
    a.sc = sc;
    a.dt = dt;
    a.h_min = h_min;
    a.eta = eta;
    a.k = k;
    const int warps = (k + 31) / 32;
    const int threads = warps < SUB_PRED_THREADS / 32 ? warps * 32
                                                      : SUB_PRED_THREADS;
    substep_predict<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// The override delta, the corrector and the flag (substep_correct): reads
// w, mass [K], kernel 2c's a1 and j1 ([K, 3]), h = sc[1], th = sc[2], *dt
// and eps2 (*eps2_ptr, or the value where eps2_ptr is null); updates s in
// place, writes sc[0] = th and sc[3] = (th < dt). One launch; returns its
// cudaGetLastError().
int substep_correct_launch(float* w, float* s, float* sc,
                           const float* mass, const float* a1,
                           const float* j1, const float* dt,
                           const float* eps2_ptr, float eps2, float g, int k,
                           void* stream)
{
    SubArgs a{};
    a.s = s;
    a.w = w;
    a.sc = sc;
    a.dt = dt;
    a.eps2_ptr = eps2_ptr;
    a.mass = mass;
    a.a1 = a1;
    a.j1 = j1;
    a.eps2 = eps2;
    a.g = g;
    a.k = k;
    const dim3 grid((k + SUB_ROWS - 1) / SUB_ROWS);
    substep_correct<<<grid, SUB_ROWS * SUB_LANES, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
