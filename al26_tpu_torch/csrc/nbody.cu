// Direct-summation N-body kernels for Hopper (sm_90a), built by nvcc into a
// shared library with a plain C interface and bound with ctypes
// (al26_tpu_torch/ops/cuda_nbody.py builds and loads it at first use).
//
// Two kernels, one pairwise loop:
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
//   * Each staged column carries its group id in shared memory beside its
//     mass (one division per column and block; -2 beyond the split's end),
//     so no pair divides; a row of group g keeps the pair when the column's
//     group is g and the column is not its own id (a select, never a
//     product with 0). A padding row (group -1) keeps none.
//   * The bound: B gs^2 useful pairs (one realization each), plus the
//     masked pairs of blocks whose rows straddle two groups, roughly TB/gs
//     of the work for contiguous rows; still bound by FP32 throughput.
// The per-tile two-level sums and the ordered reduce_partials are shared
// with the plain sweep, so a repeat gives the same bits.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int TB = 128;      // rows (threads) per block
constexpr int TJ = 256;      // source columns per shared-memory tile
constexpr int NSUM = 7;      // ax ay az jx jy jz pot

template <bool WITH_JERK, bool WITH_POT, bool SEP_POT, bool PRED, bool GROUP>
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
    int cols_per_split,                    // !GROUP only
    int gs,                                // GROUP only: stars per group
    const float* __restrict__ tau_ptr,     // [1] PRED only
    float eps2,
    float pot_eps2,
    float* __restrict__ partial)           // [splits, B, NSUM]
{
    __shared__ float sx[TJ], sy[TJ], sz[TJ];
    __shared__ float svx[TJ], svy[TJ], svz[TJ];
    __shared__ float sm[TJ];
    __shared__ int sg[TJ];                 // GROUP only: column group ids
    __shared__ int s_lo, s_hi;             // GROUP only: the rows' id range

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

    int c_begin, c_end;
    int gi = -1;                           // this row's group
    if (GROUP) {
        if (threadIdx.x == 0) {
            s_lo = INT_MAX;
            s_hi = -1;
        }
        __syncthreads();
        if (id >= 0) {
            atomicMin(&s_lo, id);
            atomicMax(&s_hi, id);
            gi = id / gs;
        }
        __syncthreads();
        int w_lo = 0, w_hi = 0;            // empty for all-padding blocks
        if (s_hi >= 0) {
            w_lo = (s_lo / gs) * gs;
            w_hi = min(n, (s_hi / gs + 1) * gs);
        }
        // whole tiles per split from the window's start, as
        // cols_per_split_of does for [0, n)
        const int splits = static_cast<int>(gridDim.y);
        const int tiles = (w_hi - w_lo + TJ - 1) / TJ;
        const int per_split = (tiles + splits - 1) / splits * TJ;
        c_begin = w_lo + static_cast<int>(blockIdx.y) * per_split;
        c_end = min(w_hi, c_begin + per_split);
    } else {
        c_begin = blockIdx.y * cols_per_split;
        c_end = min(n, c_begin + cols_per_split);
    }
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
            if (GROUP) sg[k] = c < c_end ? c / gs : -2;
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
            // (GROUP: by the staged group id, -2 past the range)
            const bool valid = GROUP ? (col != id) && (sg[k] == gi)
                                     : (col != id) && (col < c_end);
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

// The row sweep (no prediction) for one (jerk, potential) mode; GROUP
// takes the block-diagonal window of gs-star groups.
template <bool GROUP>
void launch_rows(dim3 grid, cudaStream_t st,
                 const float* rows_pos, const float* rows_vel,
                 const int* row_ids, int b, const float* pos,
                 const float* vel, const float* mass, int n, int gs,
                 float eps2, float pot_eps2,
                 int with_jerk, int with_pot, int sep_pot, float* partial)
{
    const int cps = cols_per_split_of(n, grid.y);
#define AL26_ROWS(J, P, S)                                                  \
    pair_sweep<J, P, S, false, GROUP><<<grid, TB, 0, st>>>(                 \
        rows_pos, rows_vel, row_ids, b, pos, vel, nullptr, nullptr, mass,   \
        n, cps, gs, nullptr, eps2, pot_eps2, partial)
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
        launch_rows<true>(grid, st, rows_pos, rows_vel, row_ids, b, pos, vel,
                          mass, n, group_size, eps2, pot_eps2, with_jerk,
                          with_pot, sep_pot, partial);
    else
        launch_rows<false>(grid, st, rows_pos, rows_vel, row_ids, b, pos,
                           vel, mass, n, 0, eps2, pot_eps2, with_jerk,
                           with_pot, sep_pot, partial);
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
    pair_sweep<true, false, false, true, false><<<grid, TB, 0, st>>>(
        rows_pos, rows_vel, row_ids, b, pos0, vel0, acc0, jerk0, mass, n,
        cps, 0, tau, eps2, 0.f, partial);
    const int rb = 256;
    reduce_partials<<<(b * NSUM + rb - 1) / rb, rb, 0, st>>>(
        partial, splits, b, g, 1, 0, acc, jerk, nullptr);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
