// Barnes-Hut near-field kernel for Hopper (sm_90a), built by nvcc into a
// shared library with a plain C interface and bound with ctypes
// (al26_tpu_torch/ops/cuda_tree.py builds and loads it at first use).
//
//   near_tiles  replaces al26_tpu/ops/pallas_tree.py::_near_kernel (entry
//               point pallas_p2p_near_field): the exact pair sums of the
//               Barnes-Hut tier over the MAC-failing (target leaf block,
//               source leaf block) pairs. Stars are Morton-sorted into B
//               padded blocks of `leaf` slots; for every target row,
//                 acc  = G sum_j m_j dx / r^3
//                 jerk = G sum_j m_j [dv / r^3 - 3 (dx.dv) dx / r^5]
//                 pot  = -G sum_j m_j / r   (optionally softened by a
//                                            separate pot_eps2)
//               over the source slots j of every source block paired with
//               the row's block.
//
// Input: the flat target-major pair list of ops.tree.pack_pair_list as
// per-target-block runs (src[start[t] .. start[t] + count[t]) are the
// source blocks of target block t). One CTA per target block, one thread
// per target row (a loop over row chunks when leaf > blockDim), so every
// output row is written by exactly one thread: no atomics, and a repeat
// run gives the same bits. Blocks with no pairs write zeros.
//
// What bounds it: each pair costs about 50 flops with jerk (30 without)
// and one rsqrt (two with a separate potential softening); each source
// block (leaf * 28 bytes) is read once per target block that pairs with
// it, from L2. So, like the direct sweep, it is bound by FP32 and
// SFU throughput. The source block is staged through shared memory as SoA
// float arrays in tiles of TJ, the inner loop reads broadcast
// shared-memory words, and the seven sums live in registers. Sums are
// taken per tile (at most TJ terms), then added to the running totals, so
// f32 round-off grows with TJ + pairs * leaf / TJ terms rather than with
// the full pair count.
//
// Load balance, not addressed here: partner counts are heavy-tailed on
// fractal ICs (N = 4e5, theta = 0.75: mean 171 of 2048 blocks, max 1515),
// and one CTA per target block is bounded by the longest run.
//
// Masks are selects, never products with 0 (0 * inf = NaN): the self pair
// by sorted slot (each star owns exactly one slot) and padding columns by
// slot >= n_true. The squared distance d2 is formed once; r^2 = d2 + eps2
// for the forces and d2 + pot_eps2 for the separately softened potential
// (the JAX form r2 - eps2 + pot_eps2 cancels in f32 when d2 << eps2).

#include <cuda_runtime.h>

namespace {

constexpr int TJ = 256;        // source columns per shared-memory tile
constexpr int MAX_THREADS = 256;

template <bool WITH_JERK, bool SEP_POT>
__global__ void __launch_bounds__(MAX_THREADS) near_tiles(
    const float* __restrict__ pos,     // [B*L, 3] sorted, padded
    const float* __restrict__ vel,     // [B*L, 3] (WITH_JERK only)
    const float* __restrict__ mass,    // [B*L] (padding slots 0)
    const int* __restrict__ src,       // [P] source block per pair
    const int* __restrict__ start,     // [B] first pair of each target
    const int* __restrict__ count,     // [B] pairs of each target
    int leaf, int n_true, float eps2, float pot_eps2, float g,
    float* __restrict__ acc,           // [B*L, 3]
    float* __restrict__ jerk,          // [B*L, 3] (WITH_JERK only)
    float* __restrict__ pot)           // [B*L]
{
    __shared__ float sx[TJ], sy[TJ], sz[TJ];
    __shared__ float svx[TJ], svy[TJ], svz[TJ];
    __shared__ float sm[TJ];

    const int t = blockIdx.x;
    const int p_begin = start[t];
    const int p_end = p_begin + count[t];

    for (int r0 = 0; r0 < leaf; r0 += blockDim.x) {
        const int r = r0 + threadIdx.x;
        const bool live = r < leaf;
        const int grow = t * leaf + r;             // this row's slot
        float xi = 0.f, yi = 0.f, zi = 0.f;
        float vxi = 0.f, vyi = 0.f, vzi = 0.f;
        if (live) {
            xi = pos[3 * grow + 0];
            yi = pos[3 * grow + 1];
            zi = pos[3 * grow + 2];
            if (WITH_JERK) {
                vxi = vel[3 * grow + 0];
                vyi = vel[3 * grow + 1];
                vzi = vel[3 * grow + 2];
            }
        }
        float ax = 0.f, ay = 0.f, az = 0.f;
        float jx = 0.f, jy = 0.f, jz = 0.f;
        float pt = 0.f;

        for (int p = p_begin; p < p_end; ++p) {
            const int s = src[p];
            for (int c0 = 0; c0 < leaf; c0 += TJ) {
                const int ncols = min(TJ, leaf - c0);
                const int gcol0 = s * leaf + c0;
                __syncthreads();  // the previous tile has been consumed
                for (int k = threadIdx.x; k < ncols; k += blockDim.x) {
                    const int c = gcol0 + k;
                    sx[k] = pos[3 * c + 0];
                    sy[k] = pos[3 * c + 1];
                    sz[k] = pos[3 * c + 2];
                    if (WITH_JERK) {
                        svx[k] = vel[3 * c + 0];
                        svy[k] = vel[3 * c + 1];
                        svz[k] = vel[3 * c + 2];
                    }
                    sm[k] = mass[c];
                }
                __syncthreads();

                float tax = 0.f, tay = 0.f, taz = 0.f;
                float tjx = 0.f, tjy = 0.f, tjz = 0.f;
                float tpt = 0.f;
#pragma unroll 4
                for (int k = 0; k < ncols; ++k) {
                    const int gcol = gcol0 + k;
                    const float dx = sx[k] - xi;
                    const float dy = sy[k] - yi;
                    const float dz = sz[k] - zi;
                    const float d2 = dx * dx + dy * dy + dz * dz;
                    const float mj = sm[k];
                    const bool valid = (gcol != grow) && (gcol < n_true);
                    const float inv_r = valid ? rsqrtf(d2 + eps2) : 0.f;
                    const float inv_r2 = inv_r * inv_r;
                    const float w = mj * (inv_r * inv_r2);  // m_j / r^3
                    tax += w * dx;
                    tay += w * dy;
                    taz += w * dz;
                    if (WITH_JERK) {
                        const float dvx = svx[k] - vxi;
                        const float dvy = svy[k] - vyi;
                        const float dvz = svz[k] - vzi;
                        const float q =
                            3.0f * (dx * dvx + dy * dvy + dz * dvz) * inv_r2;
                        tjx += w * (dvx - q * dx);
                        tjy += w * (dvy - q * dy);
                        tjz += w * (dvz - q * dz);
                    }
                    if (SEP_POT) {
                        const float inv_rp =
                            valid ? rsqrtf(d2 + pot_eps2) : 0.f;
                        tpt -= mj * inv_rp;
                    } else {
                        tpt -= mj * inv_r;
                    }
                }
                ax += tax; ay += tay; az += taz;
                jx += tjx; jy += tjy; jz += tjz;
                pt += tpt;
            }
        }
        if (live) {
            acc[3 * grow + 0] = g * ax;
            acc[3 * grow + 1] = g * ay;
            acc[3 * grow + 2] = g * az;
            if (WITH_JERK) {
                jerk[3 * grow + 0] = g * jx;
                jerk[3 * grow + 1] = g * jy;
                jerk[3 * grow + 2] = g * jz;
            }
            pot[grow] = g * pt;
        }
    }
}

template <bool WITH_JERK, bool SEP_POT>
void launch(int b, int threads, cudaStream_t st, const float* pos,
            const float* vel, const float* mass, const int* src,
            const int* start, const int* count, int leaf, int n_true,
            float eps2, float pot_eps2, float g, float* acc, float* jerk,
            float* pot)
{
    near_tiles<WITH_JERK, SEP_POT><<<b, threads, 0, st>>>(
        pos, vel, mass, src, start, count, leaf, n_true, eps2, pot_eps2, g,
        acc, jerk, pot);
}

}  // namespace

extern "C" {

// Kernel 3. `threads` (a multiple of 32, at most 256) rows per pass.
// Returns cudaGetLastError() after the launch.
int near_field_launch(
    const float* pos, const float* vel, const float* mass,
    const int* src, const int* start, const int* count,
    int b, int leaf, int n_true, int threads,
    float eps2, float pot_eps2, float g, int with_jerk, int sep_pot,
    float* acc, float* jerk, float* pot, void* stream)
{
    if (b == 0) return 0;
    if (threads <= 0 || threads > MAX_THREADS) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (with_jerk) {
        if (sep_pot)
            launch<true, true>(b, threads, st, pos, vel, mass, src, start,
                               count, leaf, n_true, eps2, pot_eps2, g, acc,
                               jerk, pot);
        else
            launch<true, false>(b, threads, st, pos, vel, mass, src, start,
                                count, leaf, n_true, eps2, pot_eps2, g, acc,
                                jerk, pot);
    } else {
        if (sep_pot)
            launch<false, true>(b, threads, st, pos, vel, mass, src, start,
                                count, leaf, n_true, eps2, pot_eps2, g, acc,
                                jerk, pot);
        else
            launch<false, false>(b, threads, st, pos, vel, mass, src, start,
                                 count, leaf, n_true, eps2, pot_eps2, g, acc,
                                 jerk, pot);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
