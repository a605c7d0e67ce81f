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
// big-minus-big cancellation.
//   * Shape: one warp per 16 target rows, mma.sync m16n8k8 with TF32
//     operands and f32 accumulation. Each lane computes, in registers, the
//     four elements of the 16 x 8 A fragment it owns (its two rows g, g+8
//     against its two columns t, t+4 of an 8-column chunk): A = w for Sw,
//     ws for Sws. B is the chunk's 8 x 8 slice of C8, staged in shared
//     memory while the tile is staged; the 16 x 8 accumulator is exactly
//     Sw (and Sws) of those rows, since n = 8 is C8's width.
//   * Precision: one TF32 product keeps ~3 digits, which the cancellation
//     above would amplify past the bar. Both operands are split into TF32
//     hi + lo parts (a Veltkamp split, split_tf32) and each product is
//     hi.hi + hi.lo + lo.hi ("3xTF32", ~f32 accuracy). Each chunk's three
//     products go into a fresh
//     accumulator that is added to the tile's sums with f32 adds, tiles to
//     the running sums, splits in order in reduce_partials_mma: per-tile
//     sums as in the FMA body, and no long accumulation inside the tensor
//     core.
//   * A separately softened potential (pot_eps2) is not linear in the
//     columns: it stays an explicit per-pair sum in each lane, reduced over
//     the four lanes of a quad by shuffles in a fixed order. d2 is formed
//     once and each softening added to it. Masks are selects.
//   * The bound is the same work as the FMA body (~50 flops a pair with the
//     jerk, as the JAX cost estimate counts it): the tensor cores take the
//     ~13 accumulation FMAs of a pair off the FP32 pipe, the hi/lo splits
//     (two a pair with the jerk, four FP32 operations each) and the rsqrt
//     stay.
//   * reduce_partials_mma sums the [splits, B, 17] partials (Sw, Sws, the
//     explicit potential) in split order and applies the row recovery, one
//     warp per row; a repeat gives the same bits.

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

// ---------------------------------------------------------------------------
// the matmul reduction (use_mxu=True)
// ---------------------------------------------------------------------------

constexpr int MW = 8;              // warps per block
constexpr int MT = 32 * MW;        // threads per block: one staged column each
constexpr int MROWS = 16 * MW;     // rows per block (16 per warp)
constexpr int NS_MMA = 17;         // Sw[8], Sws[8], explicit potential
static_assert(MT == TJ, "one staged column per thread");
static_assert(MROWS == TB, "the wrapper's column splits assume TB rows");

// potential modes of the matmul sweep
constexpr int POT_NONE = 0;        // not asked for
constexpr int POT_EXPLICIT = 1;    // -sum m/r at eps2 (eps2 < 1e-2)
constexpr int POT_SEPARATE = 2;    // -sum m/r at pot_eps2
constexpr int POT_PRODUCT = 3;     // through Sw (eps2 >= 1e-2)

// x = hi + lo exactly, hi with 11 significant bits (a TF32 value) and lo
// with at most 12: the 3xTF32 operand split, as a Veltkamp split in four
// FP32 operations at the full FP32 rate (a cvt.rna.tf32.f32 runs on the
// conversion pipe at a quarter of it, integer rounding at half). The _rn
// intrinsics keep the compiler from fusing them into an FMA, which would
// break the split. The tensor core truncates lo to TF32, an error of at
// most 2^-23 |x|.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo)
{
    const float c = __fmul_rn(x, 8193.0f);        // 2^13 + 1
    const float h = __fsub_rn(c, __fsub_rn(c, x));
    hi = __float_as_uint(h);
    lo = __float_as_uint(__fsub_rn(x, h));
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

// sum of hi.hi + hi.lo + lo.hi, into a fresh accumulator
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4],
                                           unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1)
{
    d[0] = d[1] = d[2] = d[3] = 0.f;
    mma_tf32(d, alo, bh0, bh1);
    mma_tf32(d, ahi, bl0, bl1);
    mma_tf32(d, ahi, bh0, bh1);
}

template <bool WITH_JERK, int POT, bool PRED>
__global__ void __launch_bounds__(MT) pair_sweep_mma(
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
    const float* __restrict__ centre,      // [6] mean pos, mean vel of cols
    const float* __restrict__ tau_ptr,     // [1] PRED only
    float eps2,
    float pot_eps2,
    float* __restrict__ partial)           // [splits, B, NS_MMA]
{
    __shared__ float4 s_pm[TJ];            // centred x, y, z and the mass
    __shared__ float4 s_v[TJ];             // centred vx, vy, vz
    __shared__ unsigned s_bhi[TJ * 8];     // C8 rows: TF32 high parts
    __shared__ unsigned s_blo[TJ * 8];     // and low parts

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int gq = lane >> 2;              // fragment row group
    const int tq = lane & 3;               // thread in the group

    const float cpx = centre[0], cpy = centre[1], cpz = centre[2];
    const float cvx = centre[3], cvy = centre[4], cvz = centre[5];
    float tau = 0.f, t2h = 0.f, t3h = 0.f;
    if (PRED) {
        tau = *tau_ptr;
        t2h = 0.5f * tau * tau;
        t3h = t2h * tau * (1.0f / 3.0f);
    }
    // the rows' shift: the columns' centre, drifted to tau for PRED
    const float shx = PRED ? cpx + tau * cvx : cpx;
    const float shy = PRED ? cpy + tau * cvy : cpy;
    const float shz = PRED ? cpz + tau * cvz : cpz;

    // this lane's two rows: gq and gq + 8 of the warp's 16
    const int base = blockIdx.x * MROWS + warp * 16 + gq;
    float xi[2], yi[2], zi[2], vxi[2], vyi[2], vzi[2];
    int id[2];
    bool live[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int row = base + 8 * q;
        live[q] = row < b;
        xi[q] = yi[q] = zi[q] = vxi[q] = vyi[q] = vzi[q] = 0.f;
        id[q] = -1;
        if (live[q]) {
            xi[q] = rows_pos[3 * row + 0] - shx;
            yi[q] = rows_pos[3 * row + 1] - shy;
            zi[q] = rows_pos[3 * row + 2] - shz;
            if (WITH_JERK) {
                vxi[q] = rows_vel[3 * row + 0] - cvx;
                vyi[q] = rows_vel[3 * row + 1] - cvy;
                vzi[q] = rows_vel[3 * row + 2] - cvz;
            }
            id[q] = row_ids[row];
        }
    }

    const int c_begin = blockIdx.y * cols_per_split;
    const int c_end = min(n, c_begin + cols_per_split);
    float sw[4] = {0.f, 0.f, 0.f, 0.f};    // running Sw fragment
    float ss[4] = {0.f, 0.f, 0.f, 0.f};    // running Sws fragment
    float pot[2] = {0.f, 0.f};             // explicit potential, rows gq, gq+8

    for (int t0 = c_begin; t0 < c_end; t0 += TJ) {
        __syncthreads();  // the previous tile has been consumed
        {
            const int k = threadIdx.x;
            const int c = t0 + k;
            float px = 0.f, py = 0.f, pz = 0.f;
            float qx = 0.f, qy = 0.f, qz = 0.f, m = 0.f, one = 0.f;
            if (c < c_end) {
                px = pos[3 * c + 0] - cpx;
                py = pos[3 * c + 1] - cpy;
                pz = pos[3 * c + 2] - cpz;
                if (WITH_JERK) {
                    qx = vel[3 * c + 0] - cvx;
                    qy = vel[3 * c + 1] - cvy;
                    qz = vel[3 * c + 2] - cvz;
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
                one = 1.f;
            }
            s_pm[k] = make_float4(px, py, pz, m);
            s_v[k] = make_float4(qx, qy, qz, 0.f);
            const float c8[8] = {px, py, pz, qx, qy, qz, one,
                                 px * px + py * py + pz * pz};
#pragma unroll
            for (int e = 0; e < 8; ++e)
                split_tf32(c8[e], s_bhi[8 * k + e], s_blo[8 * k + e]);
        }
        __syncthreads();

        float tw[4] = {0.f, 0.f, 0.f, 0.f};  // this tile's sums
        float ts[4] = {0.f, 0.f, 0.f, 0.f};
        float tp[2] = {0.f, 0.f};
#pragma unroll 2
        for (int k0 = 0; k0 < TJ; k0 += 8) {
            // A fragments: element q + 2 cc is (row gq + 8 q, col tq + 4 cc)
            unsigned awh[4], awl[4], ash[4], asl[4];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
                const int kc = k0 + tq + 4 * cc;
                const int col = t0 + kc;
                const float4 pm = s_pm[kc];
                float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
                if (WITH_JERK) vv = s_v[kc];
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int e = q + 2 * cc;
                    const float dx = pm.x - xi[q];
                    const float dy = pm.y - yi[q];
                    const float dz = pm.z - zi[q];
                    const float d2 = dx * dx + dy * dy + dz * dz;
                    const bool valid = live[q] && (col != id[q])
                                       && (col < c_end);
                    const float inv_r = valid ? rsqrtf(d2 + eps2) : 0.f;
                    const float inv_r2 = inv_r * inv_r;
                    const float w = pm.w * (inv_r * inv_r2);
                    split_tf32(w, awh[e], awl[e]);
                    if (WITH_JERK) {
                        const float dvx = vv.x - vxi[q];
                        const float dvy = vv.y - vyi[q];
                        const float dvz = vv.z - vzi[q];
                        const float s = (dx * dvx + dy * dvy + dz * dvz)
                                        * inv_r2;
                        split_tf32(w * s, ash[e], asl[e]);
                    }
                    if (POT == POT_EXPLICIT) {
                        tp[q] -= pm.w * inv_r;
                    } else if (POT == POT_SEPARATE) {
                        const float inv_rp = valid ? rsqrtf(d2 + pot_eps2)
                                                   : 0.f;
                        tp[q] -= pm.w * inv_rp;
                    }
                }
            }
            // B fragment: C8[k0 + tq][gq] and C8[k0 + tq + 4][gq]
            const unsigned bh0 = s_bhi[8 * (k0 + tq) + gq];
            const unsigned bh1 = s_bhi[8 * (k0 + tq + 4) + gq];
            const unsigned bl0 = s_blo[8 * (k0 + tq) + gq];
            const unsigned bl1 = s_blo[8 * (k0 + tq + 4) + gq];
            float d[4];
            mma_3xtf32(d, awh, awl, bh0, bh1, bl0, bl1);
#pragma unroll
            for (int i = 0; i < 4; ++i) tw[i] += d[i];
            if (WITH_JERK) {
                mma_3xtf32(d, ash, asl, bh0, bh1, bl0, bl1);
#pragma unroll
                for (int i = 0; i < 4; ++i) ts[i] += d[i];
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            sw[i] += tw[i];
            ss[i] += ts[i];
        }
        pot[0] += tp[0];
        pot[1] += tp[1];
    }

    // the explicit potential: sum over the quad's four lanes (their
    // columns), in a fixed order
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        pot[q] += __shfl_xor_sync(0xffffffffu, pot[q], 1);
        pot[q] += __shfl_xor_sync(0xffffffffu, pot[q], 2);
    }
    // accumulator fragment: (row gq, cols 2tq, 2tq+1) in [0], [1], row
    // gq + 8 in [2], [3]
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int row = base + 8 * q;
        if (row < b) {
            float* out = partial + ((size_t)blockIdx.y * b + row) * NS_MMA;
            out[2 * tq + 0] = sw[2 * q + 0];
            out[2 * tq + 1] = sw[2 * q + 1];
            out[8 + 2 * tq + 0] = WITH_JERK ? ss[2 * q + 0] : 0.f;
            out[8 + 2 * tq + 1] = WITH_JERK ? ss[2 * q + 1] : 0.f;
            if (tq == 0)
                out[16] = (POT == POT_EXPLICIT || POT == POT_SEPARATE)
                              ? pot[q] : 0.f;
        }
    }
}

// Sum the matmul sweep's partials in split order, recover each row's sums
// from Sw / Sws (pallas_nbody.py:256-273, :659-666) and scale by G: one
// warp per row, lane c summing sum c over the splits (neighbouring lanes
// read neighbouring words), lane 0 recovering the row.
constexpr int RW = 8;              // rows (warps) per recovery block
template <bool PRED>
__global__ void __launch_bounds__(32 * RW) reduce_partials_mma(
    const float* __restrict__ partial, int splits, int b,
    const float* __restrict__ rows_pos, const float* __restrict__ rows_vel,
    const float* __restrict__ centre, const float* __restrict__ tau_ptr,
    float eps2, float g, int with_jerk, int pot_mode,
    float* __restrict__ acc, float* __restrict__ jerk,
    float* __restrict__ pot)                // pot may be null
{
    const int row = blockIdx.x * RW + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= b) return;                  // the whole warp: row is uniform
    float v = 0.f;
    if (lane < NS_MMA)
        for (int k = 0; k < splits; ++k)
            v += partial[((size_t)k * b + row) * NS_MMA + lane];
    float s[NS_MMA];
#pragma unroll
    for (int c = 0; c < NS_MMA; ++c) s[c] = __shfl_sync(0xffffffffu, v, c);
    if (lane != 0) return;
    // the same centred row the sweep used
    float tau = 0.f;
    if (PRED) tau = *tau_ptr;
    const float shx = PRED ? centre[0] + tau * centre[3] : centre[0];
    const float shy = PRED ? centre[1] + tau * centre[4] : centre[1];
    const float shz = PRED ? centre[2] + tau * centre[5] : centre[2];
    const float xi = rows_pos[3 * row + 0] - shx;
    const float yi = rows_pos[3 * row + 1] - shy;
    const float zi = rows_pos[3 * row + 2] - shz;
    const float sw1 = s[6];
    const float ax = s[0] - xi * sw1;
    const float ay = s[1] - yi * sw1;
    const float az = s[2] - zi * sw1;
    acc[3 * row + 0] = g * ax;
    acc[3 * row + 1] = g * ay;
    acc[3 * row + 2] = g * az;
    float jx = 0.f, jy = 0.f, jz = 0.f;
    if (with_jerk) {
        const float vxi = rows_vel[3 * row + 0] - centre[3];
        const float vyi = rows_vel[3 * row + 1] - centre[4];
        const float vzi = rows_vel[3 * row + 2] - centre[5];
        const float sws1 = s[14];
        // the jerk's factor 3 once per row, not once per pair
        jx = (s[3] - vxi * sw1) - 3.0f * (s[8] - xi * sws1);
        jy = (s[4] - vyi * sw1) - 3.0f * (s[9] - yi * sws1);
        jz = (s[5] - vzi * sw1) - 3.0f * (s[10] - zi * sws1);
    }
    jerk[3 * row + 0] = g * jx;
    jerk[3 * row + 1] = g * jy;
    jerk[3 * row + 2] = g * jz;
    if (pot != nullptr) {
        float p = 0.f;
        if (pot_mode == POT_PRODUCT) {
            // sum w r^2 = S7 - 2 x_i.a - |x_i|^2 sw1 + eps2 sw1
            const float xi2 = xi * xi + yi * yi + zi * zi;
            p = -(s[7] + (eps2 - xi2) * sw1
                  - 2.0f * (xi * ax + yi * ay + zi * az));
        } else if (pot_mode != POT_NONE) {
            p = s[16];
        }
        pot[row] = g * p;
    }
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

// Kernel 1, matmul reduction. pot_mode: 0 none, 1 explicit at eps2, 2
// explicit at pot_eps2, 3 through the product. partial holds
// [splits, B, 17] floats. Returns cudaGetLastError() after the launches.
int nbody_rows_mma_launch(
    const float* rows_pos, const float* rows_vel, const int* row_ids, int b,
    const float* pos, const float* vel, const float* mass, int n,
    const float* centre, float eps2, float pot_eps2, float g,
    int with_jerk, int pot_mode,
    float* partial, int splits,
    float* acc, float* jerk, float* pot, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int cps = cols_per_split_of(n, splits);
    dim3 grid((b + MROWS - 1) / MROWS, splits);
#define AL26_MMA(J, P)                                                       \
    pair_sweep_mma<J, P, false><<<grid, MT, 0, st>>>(                       \
        rows_pos, rows_vel, row_ids, b, pos, vel, nullptr, nullptr, mass, n, \
        cps, centre, nullptr, eps2, pot_eps2, partial)
#define AL26_MMA_POT(J)                                                      \
    switch (pot_mode) {                                                      \
        case POT_EXPLICIT: AL26_MMA(J, POT_EXPLICIT); break;                 \
        case POT_SEPARATE: AL26_MMA(J, POT_SEPARATE); break;                 \
        case POT_PRODUCT: AL26_MMA(J, POT_PRODUCT); break;                   \
        default: AL26_MMA(J, POT_NONE); break;                               \
    }
    if (with_jerk) {
        AL26_MMA_POT(true)
    } else {
        AL26_MMA_POT(false)
    }
#undef AL26_MMA_POT
#undef AL26_MMA
    reduce_partials_mma<false><<<(b + RW - 1) / RW, 32 * RW, 0, st>>>(
        partial, splits, b, rows_pos, rows_vel, centre, nullptr, eps2, g,
        with_jerk, pot_mode, acc, jerk, pot);
    return static_cast<int>(cudaGetLastError());
}

// Kernel 2, matmul reduction: columns centred on the step-start means
// (centre), predicted to tau; rows shifted by c_pos + tau c_vel. Returns
// cudaGetLastError() after the launches.
int nbody_predcols_mma_launch(
    const float* rows_pos, const float* rows_vel, const int* row_ids, int b,
    const float* pos0, const float* vel0, const float* acc0,
    const float* jerk0, const float* mass, int n,
    const float* centre, const float* tau, float eps2, float g,
    float* partial, int splits,
    float* acc, float* jerk, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int cps = cols_per_split_of(n, splits);
    dim3 grid((b + MROWS - 1) / MROWS, splits);
    pair_sweep_mma<true, POT_NONE, true><<<grid, MT, 0, st>>>(
        rows_pos, rows_vel, row_ids, b, pos0, vel0, acc0, jerk0, mass, n,
        cps, centre, tau, eps2, 0.f, partial);
    reduce_partials_mma<true><<<(b + RW - 1) / RW, 32 * RW, 0, st>>>(
        partial, splits, b, rows_pos, rows_vel, centre, tau, eps2, g, 1,
        POT_NONE, acc, jerk, nullptr);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
