// Barnes-Hut near-field kernel for Hopper (sm_90a), built by nvcc into a
// shared library with a plain C interface and bound with ctypes
// (al26_tpu_torch/ops/cuda_tree.py builds and loads it at first use).
//
//   near_items  replaces al26_tpu/ops/pallas_tree.py::_near_kernel (entry
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
// What bounds it: each pair costs about 50 flops with the jerk (30
// without) and one rsqrt (two with a separate potential softening); a
// source block (leaf x 28 bytes) is read once per target block that pairs
// with it, from L2. So it is bound by FP32 issue, as the direct sweep is.
// Three things kept an earlier design (one CTA per target block over every
// listed pair) at ~6x its bound, and the design answers each:
//
//   * Padding pairs. B = 2^D blocks; the blocks past the last real star
//     hold only padding slots (zero mass, at the last star's position).
//     Two such blocks are coincident with radius 0, so the geometric MAC
//     (r < theta (d - r_b): 0 < 0) never accepts them and every padding
//     block pairs with every other: at N = 409600 (B = 2048, 448 padding
//     blocks) 61 % of the listed pairs. A source block of padding slots
//     only adds masked zeros, so the wrapper's item table
//     (cuda_tree.near_items) leaves out every source block s with
//     s * leaf >= n_true. Padding slots come last, so these are the last
//     entries of each target's run. Pairs of a padding target with a real
//     source stay: the contract defines those rows.
//   * Load balance. Run lengths are heavy-tailed (N = 131072: mean 57
//     source blocks, p99 199, max 512), and with one CTA per target block
//     the longest run set the kernel's time. Each target block's run is
//     cut into work items of at most ITEM_PAIRS source blocks
//     (cuda_tree.ITEM_PAIRS); one CTA takes one item. A target with one
//     item writes its rows directly; the items of a target with several
//     write partial slabs, which near_reduce sums in item order, so the
//     bits do not depend on scheduling. The grid is a static bound on the
//     item count (B + ceil(budget / ITEM_PAIRS)), so nothing is read back
//     to the host; the CTAs past the real items exit at once.
//   * The inner loop: pair_fma.cuh (packed float4 columns, cp.async double
//     buffering, the SFU's rsqrt, masks only in the source blocks that can
//     hold a masked pair: the target's own block (the self pair) and the
//     one block that straddles n_true (padding columns)).
//
// Sums are taken per tile, then per item, then across a target's items in
// item order, so the f32 round-off grows with the tile width plus the tile
// and item counts, not with the pair count; a repeat gives the same bits.
// The squared distance is formed once; r^2 = d2 + eps2 for the forces and
// d2 + pot_eps2 for the separately softened potential.

#include <cuda_runtime.h>

#include "pair_fma.cuh"

namespace {

using pair_fma::Row;
using pair_fma::Sums;
using pair_fma::Tile;
using pair_fma::TILE;

constexpr int MAX_THREADS = 256;
constexpr int NS = 7;          // ax ay az jx jy jz pot per partial row

// Everything a launch needs, passed by value (kernel parameter space).
struct NearArgs {
    const float* pos;          // [B*L, 3] sorted, padded
    const float* vel;          // [B*L, 3] (WITH_JERK only)
    const float* mass;         // [B*L] (padding slots 0)
    const int* src;            // [P] source block of each listed pair
    const int* item;           // [3, I] target block (b: none), first pair,
                               // pairs of each work item
    const int* tinfo;          // [2, B] first item, items of each target
    int n_items, b, leaf, n_true;
    float eps2, pot_eps2, g;
    float* partial;            // [I, NS, L] partial slabs
    float* acc;                // [B*L, 3]
    float* jerk;               // [B*L, 3] (WITH_JERK only)
    float* pot;                // [B*L]
};

template <bool WITH_JERK, bool SEP_POT>
__global__ void __launch_bounds__(MAX_THREADS) near_items(
    const __grid_constant__ NearArgs a)
{
    __shared__ Tile tiles[2];

    const int it = blockIdx.x;
    const int t = a.item[it];
    if (t >= a.b) return;                  // past the real items
    const int p0 = a.item[a.n_items + it];
    const int np = a.item[2 * a.n_items + it];
    const int items_of_t = a.tinfo[a.b + t];
    const int leaf = a.leaf;
    const int tpb = (leaf + TILE - 1) / TILE;   // tiles per source block
    const int n_tiles = np * tpb;
    const int tid = threadIdx.x;

    // stage tile j (source block src[p0 + j / tpb], columns from
    // (j % tpb) * TILE) into buffer `buf`
    auto stage = [&](int j, int buf) {
        const int s = a.src[p0 + j / tpb];
        const int c0 = (j % tpb) * TILE;
        const int ncols = min(TILE, leaf - c0);
        for (int k = tid; k < ncols; k += blockDim.x)
            pair_fma::stage_column_async<WITH_JERK>(
                tiles[buf], k, a.pos, a.vel, a.mass, s * leaf + c0 + k);
    };

    for (int r0 = 0; r0 < leaf; r0 += blockDim.x) {
        const int r = r0 + tid;
        const bool live = r < leaf;
        const int grow = t * leaf + r;             // this row's slot
        Row row = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (live) {
            row.x = a.pos[3 * grow + 0];
            row.y = a.pos[3 * grow + 1];
            row.z = a.pos[3 * grow + 2];
            if (WITH_JERK) {
                row.vx = a.vel[3 * grow + 0];
                row.vy = a.vel[3 * grow + 1];
                row.vz = a.vel[3 * grow + 2];
            }
        }
        Sums s = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

        // double buffer: tile j + 1 is copied (cp.async) while tile j is
        // swept; one barrier a tile (the last one also ends a row pass)
        if (n_tiles > 0) {
            stage(0, 0);
            pair_fma::cp_async_wait_all();
            __syncthreads();
        }
        for (int j = 0; j < n_tiles; ++j) {
            if (j + 1 < n_tiles) stage(j + 1, (j + 1) & 1);
            const int sb = a.src[p0 + j / tpb];
            const int c0 = (j % tpb) * TILE;
            const int ncols = min(TILE, leaf - c0);
            const int col0 = sb * leaf + c0;
            const Tile& tile = tiles[j & 1];
            // masks only where the tile can hold the self pair (the
            // target's own block) or padding columns (the block that
            // straddles n_true)
            if (sb == t || col0 + ncols > a.n_true)
                pair_fma::sweep_tile<WITH_JERK, true, SEP_POT, true>(
                    tile, ncols, row, 0, a.n_true - col0,
                    sb == t ? r - c0 : -1, a.eps2, a.pot_eps2, s);
            else
                pair_fma::sweep_tile<WITH_JERK, true, SEP_POT, false>(
                    tile, ncols, row, 0, ncols, -1, a.eps2, a.pot_eps2, s);
            pair_fma::cp_async_wait_all();
            __syncthreads();
        }
        if (!live) continue;
        if (items_of_t == 1) {
            a.acc[3 * grow + 0] = a.g * s.ax;
            a.acc[3 * grow + 1] = a.g * s.ay;
            a.acc[3 * grow + 2] = a.g * s.az;
            if (WITH_JERK) {
                a.jerk[3 * grow + 0] = a.g * s.jx;
                a.jerk[3 * grow + 1] = a.g * s.jy;
                a.jerk[3 * grow + 2] = a.g * s.jz;
            }
            a.pot[grow] = a.g * s.pot;
        } else {
            float* out = a.partial + (size_t)it * NS * leaf + r;
            out[0 * leaf] = s.ax;
            out[1 * leaf] = s.ay;
            out[2 * leaf] = s.az;
            out[3 * leaf] = s.jx;
            out[4 * leaf] = s.jy;
            out[5 * leaf] = s.jz;
            out[6 * leaf] = s.pot;
        }
    }
}

// The rows of the targets with several items: their partial slabs summed
// in item order and scaled by G. One thread per (target block, sum, row),
// so neighbouring threads read neighbouring words of a slab.
__global__ void near_reduce(const __grid_constant__ NearArgs a,
                            int with_jerk)
{
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int leaf = a.leaf;
    if (e >= (size_t)a.b * NS * leaf) return;
    const int r = static_cast<int>(e % leaf);
    const int c = static_cast<int>((e / leaf) % NS);
    const int t = static_cast<int>(e / ((size_t)leaf * NS));
    const int k1 = a.tinfo[a.b + t];
    if (k1 <= 1 || (!with_jerk && c >= 3 && c < 6)) return;
    const int i0 = a.tinfo[t];
    float sum = 0.f;
    for (int k = 0; k < k1; ++k)
        sum += a.partial[((size_t)(i0 + k) * NS + c) * leaf + r];
    const int grow = t * leaf + r;
    if (c < 3)
        a.acc[3 * grow + c] = a.g * sum;
    else if (c < 6)
        a.jerk[3 * grow + c - 3] = a.g * sum;
    else
        a.pot[grow] = a.g * sum;
}

template <bool WITH_JERK, bool SEP_POT>
void launch(const NearArgs& a, int threads, cudaStream_t st)
{
    near_items<WITH_JERK, SEP_POT><<<a.n_items, threads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// Kernel 3: the work items (one CTA each, `threads` rows a pass, a
// multiple of 32, at most 256), then the ordered sum of the targets with
// several items. Returns cudaGetLastError() after the two launches.
int near_field_launch(
    const float* pos, const float* vel, const float* mass,
    const int* src, const int* item, const int* tinfo,
    int n_items, int b, int leaf, int n_true, int threads,
    float eps2, float pot_eps2, float g, int with_jerk, int sep_pot,
    float* partial, float* acc, float* jerk, float* pot, void* stream)
{
    if (b == 0 || n_items == 0) return 0;
    if (threads <= 0 || threads > MAX_THREADS || threads % 32 != 0)
        return cudaErrorInvalidValue;
    const NearArgs a{pos, vel, mass, src, item, tinfo, n_items, b, leaf,
                     n_true, eps2, pot_eps2, g, partial, acc, jerk, pot};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (with_jerk) {
        if (sep_pot) launch<true, true>(a, threads, st);
        else launch<true, false>(a, threads, st);
    } else {
        if (sep_pot) launch<false, true>(a, threads, st);
        else launch<false, false>(a, threads, st);
    }
    const size_t work = (size_t)b * NS * leaf;
    const int rb = 256;
    near_reduce<<<static_cast<unsigned>((work + rb - 1) / rb), rb, 0, st>>>(
        a, with_jerk);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
