// The FMA-body pair sweep shared by every FMA body: kernels 1, 1b and 2
// (csrc/nbody.cu: the direct sweep, its group windows, the predicted
// columns) and kernel 3 (csrc/tree.cu, the tree's near field). One target
// row per thread against a tile of source columns staged in shared memory,
// the seven sums of a row
//     acc  = sum_j m_j dx / r^3
//     jerk = sum_j m_j [dv / r^3 - 3 (dx.dv) dx / r^5]
//     pot  = -sum_j m_j / r   (optionally softened by a separate pot_eps2)
// left unscaled by G (the callers scale once, at the end).
//
// What the staging and the loop do, each element measured on an H100 in
// the matmul bodies of nbody.cu first:
//   * columns are staged as packed float4 (x, y, z, m) and (vx, vy, vz, -):
//     one 16-byte broadcast shared load per column and operand, not four;
//   * the next tile is copied by cp.async while the current one is swept
//     (the callers double-buffer; stage_column_async issues the copies);
//   * 1 / sqrt is the SFU's rsqrt.approx.ftz without rsqrtf's subnormal
//     fix-up: its argument is d2 plus a softening. The callers pass
//     softenings of at least 1e-30 except kernel 1 at eps2 = 0 (a
//     `softening=0` run), where a distinct pair closer than ~1e-19 pc has
//     a subnormal d2 and gets inf (rsqrtf gave a huge finite value);
//   * the self / padding / group select runs only in tiles that can hold
//     a masked pair (MASKED); every other tile runs unmasked. Masks are
//     selects, never products with 0 (0 * inf = NaN);
//   * without a separately softened potential the softening rides the
//     distance's FMA chain; with one, d2 is formed once and each softening
//     added to it (the form r2 - eps2 + pot_eps2 cancels in f32).
// Each tile's sums start from zero and are added to the running sums once a
// tile, so the f32 round-off grows with the tile width plus the tile count,
// not with the pair count.
//
// Tensor cores are not used here. The near field's pairs are the closest
// of the cluster, and the mean-centred product decomposition of the matmul
// bodies (nbody.cu) cancels as |x_j - c| / d, worst exactly there; whether
// a tile-centred decomposition keeps the 1e-5 bar is an open question.
#pragma once

#include <cuda_runtime.h>

namespace pair_fma {

// source columns per staged tile
constexpr int TILE = 256;

// 1 / sqrt(x) on the SFU without the subnormal-input fix-up rsqrtf
// carries: x is d2 + a softening, subnormal only at a softening of 0
__device__ __forceinline__ float rsqrt_ftz(float x)
{
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One staged tile: packed (x, y, z, m) and (vx, vy, vz, -) per column.
struct Tile {
    float4 pm[TILE];
    float4 v[TILE];
};

// Copy column c of pos [., 3], vel [., 3] (WITH_JERK), mass [.] into slot
// k of `t`; the copy completes at the next cp_async_wait_all.
template <bool WITH_JERK>
__device__ __forceinline__ void stage_column_async(Tile& t, int k,
                                                   const float* pos,
                                                   const float* vel,
                                                   const float* mass, int c)
{
    float* pm = reinterpret_cast<float*>(&t.pm[k]);
    cp_async4(pm + 0, pos + 3 * c + 0);
    cp_async4(pm + 1, pos + 3 * c + 1);
    cp_async4(pm + 2, pos + 3 * c + 2);
    cp_async4(pm + 3, mass + c);
    if (WITH_JERK) {
        float* v = reinterpret_cast<float*>(&t.v[k]);
        cp_async4(v + 0, vel + 3 * c + 0);
        cp_async4(v + 1, vel + 3 * c + 1);
        cp_async4(v + 2, vel + 3 * c + 2);
    }
}

// A target row: position and velocity.
struct Row {
    float x, y, z, vx, vy, vz;
};

// A row's seven sums (acc, jerk, pot), unscaled.
struct Sums {
    float ax, ay, az, jx, jy, jz, pot;
};

// The staged columns k0 <= k < k1 of a tile against this thread's row,
// added to `s` as one tile sum. MASKED keeps only the columns k with
// k_lo <= k < k_hi and k != k_self (tile-local indices); unmasked spans
// keep every column.
template <bool WITH_JERK, bool WITH_POT, bool SEP_POT, bool MASKED>
__device__ __forceinline__ void sweep_span(const Tile& t, int k0, int k1,
                                           const Row& r, int k_lo, int k_hi,
                                           int k_self, float eps2,
                                           float pot_eps2, Sums& s)
{
    float ax = 0.f, ay = 0.f, az = 0.f;
    float jx = 0.f, jy = 0.f, jz = 0.f;
    float pt = 0.f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
        const float4 p = t.pm[k];
        const float dx = p.x - r.x;
        const float dy = p.y - r.y;
        const float dz = p.z - r.z;
        float d2 = 0.f, r2;
        if (SEP_POT) {
            d2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
            r2 = d2 + eps2;
        } else {
            r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
        }
        float inv_r = rsqrt_ftz(r2);
        bool valid = true;
        if (MASKED) {
            valid = k >= k_lo && k < k_hi && k != k_self;
            inv_r = valid ? inv_r : 0.f;
        }
        const float inv_r2 = inv_r * inv_r;
        const float w = p.w * (inv_r * inv_r2);     // m_j / r^3, masked
        ax = fmaf(w, dx, ax);
        ay = fmaf(w, dy, ay);
        az = fmaf(w, dz, az);
        if (WITH_JERK) {
            const float4 q = t.v[k];
            const float dvx = q.x - r.vx;
            const float dvy = q.y - r.vy;
            const float dvz = q.z - r.vz;
            const float sv = 3.0f * (dx * dvx + dy * dvy + dz * dvz) * inv_r2;
            jx = fmaf(w, dvx - sv * dx, jx);
            jy = fmaf(w, dvy - sv * dy, jy);
            jz = fmaf(w, dvz - sv * dz, jz);
        }
        if (WITH_POT) {
            if (SEP_POT) {
                float inv_rp = rsqrt_ftz(d2 + pot_eps2);
                if (MASKED) inv_rp = valid ? inv_rp : 0.f;
                pt = fmaf(-p.w, inv_rp, pt);
            } else {
                pt = fmaf(-p.w, inv_r, pt);
            }
        }
    }
    s.ax += ax; s.ay += ay; s.az += az;
    s.jx += jx; s.jy += jy; s.jz += jz;
    s.pot += pt;
}

// sweep_span over a tile's first `ncols` columns
template <bool WITH_JERK, bool WITH_POT, bool SEP_POT, bool MASKED>
__device__ __forceinline__ void sweep_tile(const Tile& t, int ncols,
                                           const Row& r, int k_lo, int k_hi,
                                           int k_self, float eps2,
                                           float pot_eps2, Sums& s)
{
    sweep_span<WITH_JERK, WITH_POT, SEP_POT, MASKED>(t, 0, ncols, r, k_lo,
                                                     k_hi, k_self, eps2,
                                                     pot_eps2, s);
}

}  // namespace pair_fma
