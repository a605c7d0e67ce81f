// Direct-summation N-body kernels for Hopper (sm_90a), built by nvcc into a
// shared library with a plain C interface and bound with ctypes
// (al26_tpu_torch/ops/cuda_nbody.py builds and loads it at first use).
//
// Two kernels, one pairwise loop (each also in a matmul form, below):
//
//   nbody_rows     replaces al26_tpu/ops/pallas_nbody.py::_nbody_kernel
//                  (its FMA `body`, not the matmul variant): for B target rows
//                  against N source columns, with Plummer softening eps2,
//                    acc  = G sum_j m_j dx / r^3
//                    jerk = G sum_j m_j [dv / r^3 - 3 (dx.dv) dx / r^5]
//                    pot  = -G sum_j m_j / r   (optionally softened by a
//                                               separate pot_eps2)
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
//
// What bounds them: each pair costs about 50 flops with jerk (30 without)
// and one rsqrt, against 28 bytes per source column that every row block
// reads once from L2/HBM; so the sweep is bound by the FP32 issue rate and
// the rsqrt (SFU) throughput, not by memory. The design keeps every row's
// seven sums in registers (one thread per row), stages source columns
// through shared memory in tiles of TJ as SoA float arrays (so the inner
// loop reads broadcast shared-memory words), and applies the self-pair and
// padding masks with a select, never by multiplying by 0 (0 * inf = NaN).
// The f32 sums are taken per tile, then across tiles, then across column
// splits, which keeps their round-off within the 1e-5 (of the max) bar of
// the f64 result at the N of a large cluster; one running sum per row over
// all N columns does not (2.5e-5 at N = 131072 on an H100).
//
// Small row counts: a fast-group call has only 256-512 rows, so a grid of
// row blocks alone would fill 2-4 of the 132 SMs. The grid's second
// dimension therefore splits the columns into `splits` contiguous ranges;
// each block writes its partial sums to scratch, and reduce_partials adds
// them in split order, so the result does not depend on block scheduling.
//
// The squared distance d2 = dx^2 + dy^2 + dz^2 is formed once; r^2 = d2 +
// eps2 for the forces and d2 + pot_eps2 for a separately softened
// potential (the JAX form r2 - eps2 + pot_eps2 cancels in f32 when d2 is
// much smaller than eps2).
//
// Block-diagonal group windows (nbody_rows with group_size gs > 0) replace
// the `group_size > 0` mode of the same Pallas kernel
// (pallas_nbody.py:121-137 the window, :164-167 the mask, :247-248 the loop
// bounds). A flattened ensemble of B realizations of gs stars each (global
// id = realization * gs + star) is one B*gs-row sweep in which a row only
// feels the columns of its own realization: id / gs == col / gs. That is a
// different sum from the plain sweep, not a faster way to the same one.
//   * Window: each block of TB rows reduces the smallest and largest valid
//     row id among its rows (padding rows are -1) in shared memory; a
//     scattered fast-group subset may span several groups. Its columns are
//     [g_lo gs, (g_hi + 1) gs) clipped to [0, n), with
//     g_lo = min id / gs and g_hi = max id / gs. A block of padding rows
//     only has an empty window and writes zero partials.
//   * The gridDim.y column splits divide that window, not [0, n), so a
//     64000-row sweep of 64 realizations of 1000 stars does not launch
//     blocks that find no columns; tiles start at the window's start.
//   * Its own kernel (group_sweep) on the FMA loop that kernel 3 shares
//     (pair_fma.cuh: packed float4 columns, cp.async double buffering, the
//     SFU's rsqrt), so the select runs only where a tile needs it. A row
//     of group g keeps the columns of [g gs, (g + 1) gs) in its split that
//     are not its own id (a select, never a product with 0, from the
//     row's group range: no pair divides); a padding row (id -1) keeps
//     none. A block whose live rows are all real and of one group sweeps
//     only that group's columns, so its tiles run unmasked except the one
//     that holds its own ids and a split's ragged last tile (8 x 10240:
//     39 of a block's 40 tiles unmasked); a block that straddles groups,
//     holds padding rows or scatters over the ensemble masks every tile.
//   * The bound: B gs^2 useful pairs (one realization each), plus the
//     masked pairs of blocks whose rows straddle two groups, roughly TB/gs
//     of the work for contiguous rows; bound by FP32 issue and, with a
//     separately softened potential, close to the SFU's rate too.
// The per-tile two-level sums and the ordered reduce_partials are shared
// with the plain sweep, so a repeat gives the same bits.
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
//     planner (cuda_nbody.mma_plan) to fill whole waves of the card's
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

#include <climits>

#include "pair_fma.cuh"

namespace {

// the SFU's rsqrt and the cp.async helpers of the shared FMA loop
using pair_fma::rsqrt_ftz;
using pair_fma::cp_async4;
using pair_fma::cp_async_wait_all;

constexpr int TB = 128;      // rows (threads) per block
constexpr int TJ = 256;      // source columns per shared-memory tile
constexpr int NSUM = 7;      // ax ay az jx jy jz pot

template <bool WITH_JERK, bool WITH_POT, bool SEP_POT, bool PRED>
__global__ void __launch_bounds__(TB) pair_sweep(
    const float* __restrict__ rows_pos,    // [B,3]
    const float* __restrict__ rows_vel,    // [B,3]
    const int* __restrict__ row_ids,       // [B] global column id, -1 = pad
    int b,
    const float* __restrict__ pos,         // [N,3] (step-start if PRED)
    const float* __restrict__ vel,         // [N,3]
    const float* __restrict__ acc0,        // [N,3] PRED only
    const float* __restrict__ jerk0,       // [N,3] PRED only
    const float* __restrict__ mass,        // [N]
    int n,
    int cols_per_split,
    const float* __restrict__ tau_ptr,     // [1] PRED only
    float eps2,
    float pot_eps2,
    float* __restrict__ partial)           // [splits, B, NSUM]
{
    __shared__ float sx[TJ], sy[TJ], sz[TJ];
    __shared__ float svx[TJ], svy[TJ], svz[TJ];
    __shared__ float sm[TJ];

    const int row = blockIdx.x * TB + threadIdx.x;
    const bool live = row < b;
    float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
    int id = -1;
    if (live) {
        xi = rows_pos[3 * row + 0];
        yi = rows_pos[3 * row + 1];
        zi = rows_pos[3 * row + 2];
        if (WITH_JERK) {
            vxi = rows_vel[3 * row + 0];
            vyi = rows_vel[3 * row + 1];
            vzi = rows_vel[3 * row + 2];
        }
        id = row_ids[row];
    }
    float tau = 0.f, t2h = 0.f, t3h = 0.f;
    if (PRED) {
        tau = *tau_ptr;
        t2h = 0.5f * tau * tau;
        t3h = t2h * tau * (1.0f / 3.0f);
    }

    const int c_begin = blockIdx.y * cols_per_split;
    const int c_end = min(n, c_begin + cols_per_split);
    float ax = 0.f, ay = 0.f, az = 0.f;
    float jx = 0.f, jy = 0.f, jz = 0.f;
    float pot = 0.f;

    for (int t0 = c_begin; t0 < c_end; t0 += TJ) {
        __syncthreads();  // the previous tile has been consumed
        for (int k = threadIdx.x; k < TJ; k += TB) {
            const int c = t0 + k;
            float px = 0.f, py = 0.f, pz = 0.f;
            float qx = 0.f, qy = 0.f, qz = 0.f, m = 0.f;
            if (c < c_end) {
                px = pos[3 * c + 0];
                py = pos[3 * c + 1];
                pz = pos[3 * c + 2];
                if (WITH_JERK) {
                    qx = vel[3 * c + 0];
                    qy = vel[3 * c + 1];
                    qz = vel[3 * c + 2];
                }
                if (PRED) {
                    const float ax0 = acc0[3 * c + 0];
                    const float ay0 = acc0[3 * c + 1];
                    const float az0 = acc0[3 * c + 2];
                    const float jx0 = jerk0[3 * c + 0];
                    const float jy0 = jerk0[3 * c + 1];
                    const float jz0 = jerk0[3 * c + 2];
                    px = px + tau * qx + t2h * ax0 + t3h * jx0;
                    py = py + tau * qy + t2h * ay0 + t3h * jy0;
                    pz = pz + tau * qz + t2h * az0 + t3h * jz0;
                    qx = qx + tau * ax0 + t2h * jx0;
                    qy = qy + tau * ay0 + t2h * jy0;
                    qz = qz + tau * az0 + t2h * jz0;
                }
                m = mass[c];
            }
            sx[k] = px; sy[k] = py; sz[k] = pz;
            svx[k] = qx; svy[k] = qy; svz[k] = qz;
            sm[k] = m;
        }
        __syncthreads();

        // two-level summation: each tile's sums start from zero and are
        // added to the running totals once per tile, so f32 round-off grows
        // with TJ + n / TJ terms rather than with n
        float tax = 0.f, tay = 0.f, taz = 0.f;
        float tjx = 0.f, tjy = 0.f, tjz = 0.f;
        float tpot = 0.f;
#pragma unroll 4
        for (int k = 0; k < TJ; ++k) {
            const int col = t0 + k;
            const float dx = sx[k] - xi;
            const float dy = sy[k] - yi;
            const float dz = sz[k] - zi;
            const float d2 = dx * dx + dy * dy + dz * dz;
            const float mj = sm[k];
            // self pair by id, padding and other splits' columns by range
            const bool valid = (col != id) && (col < c_end);
            const float inv_r = valid ? rsqrtf(d2 + eps2) : 0.f;
            const float inv_r2 = inv_r * inv_r;
            const float w = mj * (inv_r * inv_r2);  // m_j / r^3, masked
            tax += w * dx;
            tay += w * dy;
            taz += w * dz;
            if (WITH_JERK) {
                const float dvx = svx[k] - vxi;
                const float dvy = svy[k] - vyi;
                const float dvz = svz[k] - vzi;
                const float s = 3.0f * (dx * dvx + dy * dvy + dz * dvz) * inv_r2;
                tjx += w * (dvx - s * dx);
                tjy += w * (dvy - s * dy);
                tjz += w * (dvz - s * dz);
            }
            if (WITH_POT) {
                if (SEP_POT) {
                    const float inv_rp = valid ? rsqrtf(d2 + pot_eps2) : 0.f;
                    tpot -= mj * inv_rp;
                } else {
                    tpot -= mj * inv_r;
                }
            }
        }
        ax += tax; ay += tay; az += taz;
        jx += tjx; jy += tjy; jz += tjz;
        pot += tpot;
    }
    if (live) {
        float* out = partial + ((size_t)blockIdx.y * b + row) * NSUM;
        out[0] = ax; out[1] = ay; out[2] = az;
        out[3] = jx; out[4] = jy; out[5] = jz;
        out[6] = pot;
    }
}

// Sum the per-split partials in split order and scale by G: one thread per
// (row, sum), so neighbouring threads read neighbouring words of each
// split's [B, NSUM] slab.
__global__ void reduce_partials(
    const float* __restrict__ partial, int splits, int b, float g,
    int with_jerk, int with_pot,
    float* __restrict__ acc, float* __restrict__ jerk,
    float* __restrict__ pot)                // pot may be null
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= b * NSUM) return;
    const int row = t / NSUM;
    const int c = t - row * NSUM;
    const size_t stride = (size_t)b * NSUM;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < splits; ++k) s += partial[k * stride + t];
    if (c < 3) {
        acc[3 * row + c] = g * s;
    } else if (c < 6) {
        jerk[3 * row + c - 3] = with_jerk ? g * s : 0.f;
    } else if (pot != nullptr) {
        pot[row] = with_pot ? g * s : 0.f;
    }
}

int cols_per_split_of(int n, int splits)
{
    // whole tiles per split, so only the last split has a ragged tile
    const int tiles = (n + TJ - 1) / TJ;
    const int tiles_per_split = (tiles + splits - 1) / splits;
    return tiles_per_split * TJ;
}

// The row sweep (no prediction) for one (jerk, potential) mode.
void launch_rows(dim3 grid, cudaStream_t st,
                 const float* rows_pos, const float* rows_vel,
                 const int* row_ids, int b, const float* pos,
                 const float* vel, const float* mass, int n,
                 float eps2, float pot_eps2,
                 int with_jerk, int with_pot, int sep_pot, float* partial)
{
    const int cps = cols_per_split_of(n, grid.y);
#define AL26_ROWS(J, P, S)                                                  \
    pair_sweep<J, P, S, false><<<grid, TB, 0, st>>>(                        \
        rows_pos, rows_vel, row_ids, b, pos, vel, nullptr, nullptr, mass,   \
        n, cps, nullptr, eps2, pot_eps2, partial)
    if (with_jerk) {
        if (!with_pot) AL26_ROWS(true, false, false);
        else if (sep_pot) AL26_ROWS(true, true, true);
        else AL26_ROWS(true, true, false);
    } else {
        if (!with_pot) AL26_ROWS(false, false, false);
        else if (sep_pot) AL26_ROWS(false, true, true);
        else AL26_ROWS(false, true, false);
    }
#undef AL26_ROWS
}

// ---------------------------------------------------------------------------
// kernel 1b: the block-diagonal group windows (group_size gs > 0)
// ---------------------------------------------------------------------------

// One (row block, column split) of a grouped sweep on the shared FMA loop
// (pair_fma.cuh): the block's window of groups as in the header, columns
// staged as packed float4 by cp.async into a double buffer (one barrier a
// tile), and the select only in the tiles that need it: where the block's
// live rows are all real and of one group, the split's columns are all
// that group's, so only a tile that holds one of the rows' own ids (the
// self pairs) or a split's ragged last tile is masked; a block whose rows
// straddle groups, hold padding or scatter over the ensemble (a fast
// group) masks every tile by each row's group range and id.
template <bool WITH_JERK, bool WITH_POT, bool SEP_POT>
__global__ void __launch_bounds__(TB) group_sweep(
    const float* __restrict__ rows_pos,    // [B,3]
    const float* __restrict__ rows_vel,    // [B,3]
    const int* __restrict__ row_ids,       // [B] global column id, -1 = pad
    int b,
    const float* __restrict__ pos,         // [N,3]
    const float* __restrict__ vel,         // [N,3]
    const float* __restrict__ mass,        // [N]
    int n,
    int gs,                                // stars per group
    float eps2,
    float pot_eps2,
    float* __restrict__ partial)           // [splits, B, NSUM]
{
    __shared__ pair_fma::Tile tiles[2];
    __shared__ int s_lo, s_hi, s_pad;      // the rows' id range; a padding row

    const int tid = threadIdx.x;
    const int row = blockIdx.x * TB + tid;
    const bool live = row < b;
    pair_fma::Row r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int id = -1;
    if (live) {
        r.x = rows_pos[3 * row + 0];
        r.y = rows_pos[3 * row + 1];
        r.z = rows_pos[3 * row + 2];
        if (WITH_JERK) {
            r.vx = rows_vel[3 * row + 0];
            r.vy = rows_vel[3 * row + 1];
            r.vz = rows_vel[3 * row + 2];
        }
        id = row_ids[row];
    }
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
    int w_lo = 0, w_hi = 0;                // empty for all-padding blocks
    if (s_hi >= 0) {
        w_lo = (s_lo / gs) * gs;
        w_hi = min(n, (s_hi / gs + 1) * gs);
    }
    // whole tiles per split from the window's start, as cols_per_split_of
    // does for [0, n)
    const int splits = static_cast<int>(gridDim.y);
    const int tiles_w = (w_hi - w_lo + TJ - 1) / TJ;
    const int per_split = (tiles_w + splits - 1) / splits * TJ;
    const int c_begin = w_lo + static_cast<int>(blockIdx.y) * per_split;
    const int c_end = min(w_hi, c_begin + per_split);
    const int n_tiles = c_end > c_begin ? (c_end - c_begin + TJ - 1) / TJ : 0;
    // this row's columns in the split: its own group's (none for padding)
    int g_lo = 0, g_hi = 0;
    if (id >= 0) {
        g_lo = max(c_begin, (id / gs) * gs);
        g_hi = min(c_end, (id / gs + 1) * gs);
    }
    const bool uniform = s_pad == 0 && s_hi >= 0 && s_lo / gs == s_hi / gs;

    auto stage = [&](int i, int buf) {
        const int t0 = c_begin + i * TJ;
        const int ncols = min(TJ, c_end - t0);
        for (int k = tid; k < ncols; k += TB)
            pair_fma::stage_column_async<WITH_JERK>(tiles[buf], k, pos, vel,
                                                    mass, t0 + k);
    };
    pair_fma::Sums s = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (n_tiles > 0) {
        stage(0, 0);
        cp_async_wait_all();
        __syncthreads();
    }
    for (int i = 0; i < n_tiles; ++i) {
        if (i + 1 < n_tiles) stage(i + 1, (i + 1) & 1);
        const int t0 = c_begin + i * TJ;
        const int ncols = min(TJ, c_end - t0);
        const pair_fma::Tile& tile = tiles[i & 1];
        if (uniform && ncols == TJ && (t0 > s_hi || t0 + TJ <= s_lo))
            pair_fma::sweep_tile<WITH_JERK, WITH_POT, SEP_POT, false>(
                tile, TJ, r, 0, TJ, -1, eps2, pot_eps2, s);
        else
            pair_fma::sweep_tile<WITH_JERK, WITH_POT, SEP_POT, true>(
                tile, ncols, r, g_lo - t0, g_hi - t0, id - t0, eps2,
                pot_eps2, s);
        cp_async_wait_all();
        __syncthreads();
    }
    if (live) {
        float* out = partial + ((size_t)blockIdx.y * b + row) * NSUM;
        out[0] = s.ax; out[1] = s.ay; out[2] = s.az;
        out[3] = s.jx; out[4] = s.jy; out[5] = s.jz;
        out[6] = s.pot;
    }
}

// The grouped sweep for one (jerk, potential) mode.
void launch_group(dim3 grid, cudaStream_t st,
                  const float* rows_pos, const float* rows_vel,
                  const int* row_ids, int b, const float* pos,
                  const float* vel, const float* mass, int n, int gs,
                  float eps2, float pot_eps2,
                  int with_jerk, int with_pot, int sep_pot, float* partial)
{
#define AL26_GROUP(J, P, S)                                                 \
    group_sweep<J, P, S><<<grid, TB, 0, st>>>(                              \
        rows_pos, rows_vel, row_ids, b, pos, vel, mass, n, gs, eps2,        \
        pot_eps2, partial)
    if (with_jerk) {
        if (!with_pot) AL26_GROUP(true, false, false);
        else if (sep_pot) AL26_GROUP(true, true, true);
        else AL26_GROUP(true, true, false);
    } else {
        if (!with_pot) AL26_GROUP(false, false, false);
        else if (sep_pot) AL26_GROUP(false, true, true);
        else AL26_GROUP(false, true, false);
    }
#undef AL26_GROUP
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

// Split partials: a block's sums, [rows][NS_MMA], summed by
// slab_sum over a run of splits' slabs, split by split in order; each
// thread keeps RED_WORDS words, so many loads are in flight at once.
constexpr int RED_WORDS = (MROWS * NS_MMA + MT - 1) / MT;
// splits summed by one block before the final sum over the groups
constexpr int RED_GROUP = 16;

// out[e] = sum over splits k0, k0 + step, ... (< k1), in that order, of
// partial slab k's word e (this thread's words only)
__device__ __forceinline__ void slab_sum(const MmaArgs& a, int row0,
                                         int words, int k0, int k1,
                                         int step, float* out)
{
    const int tid = threadIdx.x;
    float v[RED_WORDS];
#pragma unroll
    for (int j = 0; j < RED_WORDS; ++j) v[j] = 0.f;
#pragma unroll 2
    for (int k = k0; k < k1; k += step) {
        const float* slab = a.partial + ((size_t)k * a.b + row0) * NS_MMA;
#pragma unroll
        for (int j = 0; j < RED_WORDS; ++j) {
            const int e = tid + j * MT;
            if (e < words) v[j] += __ldcg(slab + e);
        }
    }
#pragma unroll
    for (int j = 0; j < RED_WORDS; ++j) {
        const int e = tid + j * MT;
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
// writes its slab of partials; within each group of RED_GROUP splits the
// block that takes the group's last ticket sums the group's slabs in
// split order into the group's first slab; the block that takes the last
// group ticket sums the group slabs in group order into `red`. The order
// is fixed, so the bits do not depend on which blocks finish last.
// Returns true in that one block per row block.
__device__ bool reduce_splits(const MmaArgs& a, float* red, int row0,
                              int words)
{
    const int splits = static_cast<int>(gridDim.y);
    const int groups = (splits + RED_GROUP - 1) / RED_GROUP;
    const int y = static_cast<int>(blockIdx.y);
    int* count = a.counters + (size_t)blockIdx.x * (groups + 1);
    float* slab = a.partial + ((size_t)y * a.b + row0) * NS_MMA;
    for (int e = threadIdx.x; e < words; e += MT) slab[e] = red[e];
    const int g = y / RED_GROUP;
    const int k0 = g * RED_GROUP;
    const int k1 = min(splits, k0 + RED_GROUP);
    if (!last_ticket(count + g, k1 - k0)) return false;
    if (groups == 1) {
        slab_sum(a, row0, words, 0, splits, 1, red);
        __syncthreads();
        return true;
    }
    slab_sum(a, row0, words, k0, k1, 1,
             a.partial + ((size_t)k0 * a.b + row0) * NS_MMA);
    if (!last_ticket(count + groups, groups)) return false;
    slab_sum(a, row0, words, 0, splits, RED_GROUP, red);
    __syncthreads();
    return true;
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
    if (gridDim.y > 1 && !reduce_splits(a, red, row0, rows * NS_MMA))
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

}  // namespace

extern "C" {

// Kernel 1; group_size > 0 takes the block-diagonal group windows. Returns
// cudaGetLastError() after the two launches.
int nbody_rows_launch(
    const float* rows_pos, const float* rows_vel, const int* row_ids, int b,
    const float* pos, const float* vel, const float* mass, int n,
    float eps2, float pot_eps2, float g,
    int with_jerk, int with_pot, int sep_pot, int group_size,
    float* partial, int splits,
    float* acc, float* jerk, float* pot, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((b + TB - 1) / TB, splits);
    if (group_size > 0)
        launch_group(grid, st, rows_pos, rows_vel, row_ids, b, pos, vel,
                     mass, n, group_size, eps2, pot_eps2, with_jerk,
                     with_pot, sep_pot, partial);
    else
        launch_rows(grid, st, rows_pos, rows_vel, row_ids, b, pos, vel,
                    mass, n, eps2, pot_eps2, with_jerk, with_pot, sep_pot,
                    partial);
    const int rb = 256;
    reduce_partials<<<(b * NSUM + rb - 1) / rb, rb, 0, st>>>(
        partial, splits, b, g, with_jerk, with_pot, acc, jerk, pot);
    return static_cast<int>(cudaGetLastError());
}

// Kernel 2. Returns cudaGetLastError() after the two launches.
int nbody_predcols_launch(
    const float* rows_pos, const float* rows_vel, const int* row_ids, int b,
    const float* pos0, const float* vel0, const float* acc0,
    const float* jerk0, const float* mass, int n,
    const float* tau, float eps2, float g,
    float* partial, int splits,
    float* acc, float* jerk, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int cps = cols_per_split_of(n, splits);
    dim3 grid((b + TB - 1) / TB, splits);
    pair_sweep<true, false, false, true><<<grid, TB, 0, st>>>(
        rows_pos, rows_vel, row_ids, b, pos0, vel0, acc0, jerk0, mass, n,
        cps, tau, eps2, 0.f, partial);
    const int rb = 256;
    reduce_partials<<<(b * NSUM + rb - 1) / rb, rb, 0, st>>>(
        partial, splits, b, g, 1, 0, acc, jerk, nullptr);
    return static_cast<int>(cudaGetLastError());
}

// Kernel 1, matmul reduction. pot_mode: 0 none, 1 explicit at eps2, 2
// explicit at pot_eps2, 3 through the product. splits column splits of
// cols_per_split (whole tiles) each; with splits > 1, partial holds
// [splits, B, 17] floats and counters one zeroed int per row block (every
// launch leaves them zero). One launch; returns its cudaGetLastError().
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

}  // extern "C"
