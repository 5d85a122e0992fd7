// H2: the hash DSMC engine's partner scan, for the gated targets. Port of
// sidm_tpu/ops/sidm.py:sidm_scatter's scan_block (:221-248), plain XLA in
// the JAX package (no Pallas original); see
// sidm_tpu_torch/ops/sidm.py:hash_scan for the contract.
//
// Per gated target i (the others never cross in JAX): its candidates in
// JAX's order, the deduplicated stencil buckets of the level of h_i in
// stencil order, each bucket's rows in rank order up to cap
// (hash_grid.cuh); a candidate j is valid when it has i's type, r < h_i,
// j != i and no pending kick; its term P_j = 0.5 m_j W(r/h_i)/h_i^3
// sigma(v) v dt (sidm_pair.cuh, the gated tile's pair math, rounded as the
// plain version: -fmad=false). The partner is the first candidate whose
// running sum of terms reaches the target's uniform. The sum is taken in
// another order than the plain version's cumsum, so a partner can differ
// where the uniform lies within float rounding of a running sum (a
// near-tie). A uniform of 0 crosses at the first slot, valid or not, as
// JAX's cum >= rand does.
//
// Design: a warp a target. The stencil and the flattened (bucket, rank)
// slots as in hash_knn.cu; the lanes take 32 slots at a time in order,
// scan their terms across the warp (5 shuffle steps) onto the carry of the
// earlier batches, and stop at the first batch holding a crossing; only a
// slot with a positive term may cross (a zero term adds nothing, but the
// shuffle tree may round its running sum differently from its left
// neighbour's).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_grid.cuh"
#include "sidm_pair.cuh"

namespace {

using hash_grid::Grid;
using hash_grid::kCells;
using hash_grid::kFull;
using sidm_pair::pair_prob;
using sidm_pair::Sigma;

constexpr int kWarps = 8;           // targets a block

struct WarpShared {
    int pre[kCells + 1];
    int st[kCells];
};

__global__ void __launch_bounds__(32 * kWarps)
hash_scan_kernel(Grid g, const float* __restrict__ geom,
                 const int* __restrict__ sorted_part, int LN,
                 const float* __restrict__ pos, const float* __restrict__ vel,
                 const float* __restrict__ hs, const int* __restrict__ ptype,
                 const float* __restrict__ rand,
                 const float* __restrict__ dts, const int* __restrict__ tid,
                 int T, int cap, Sigma sigma, int* __restrict__ partner,
                 int* __restrict__ hit, int* __restrict__ need_out,
                 int* __restrict__ clip_out, int* __restrict__ scanned_out) {
    __shared__ WarpShared sh[kWarps];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int q = blockIdx.x * kWarps + w;
    if (q >= T) return;                 // whole warps only
    WarpShared& s = sh[w];
    g.ox = __ldg(geom);
    g.oy = __ldg(geom + 1);
    g.oz = __ldg(geom + 2);
    g.s0 = __ldg(geom + 3);
    const int i = __ldg(tid + q);
    const float px = __ldg(pos + 3 * (int64_t)i);
    const float py = __ldg(pos + 3 * (int64_t)i + 1);
    const float pz = __ldg(pos + 3 * (int64_t)i + 2);
    const float vx = __ldg(vel + 3 * (int64_t)i);
    const float vy = __ldg(vel + 3 * (int64_t)i + 1);
    const float vz = __ldg(vel + 3 * (int64_t)i + 2);
    const float h = __ldg(hs + i), u = __ldg(rand + i), dt = __ldg(dts + i);
    const int type = __ldg(ptype + i);
    int count, start, key0;
    bool clip;
    hash_grid::stencil(g, px, py, pz, type, h, lane, &count, &start, &key0,
                       &clip);
    const int need = hash_grid::warp_max(count);
    const int total = hash_grid::stage_prefix(min(count, cap), lane, start,
                                              s.pre, s.st);
    int pj = -1, scanned = total;
    if (!(u > 0.0f)) {
        // cum >= rand at slot 0 (JAX: idx of slot 0, its entry clipped)
        if (u == 0.0f) {
            pj = __ldg(sorted_part + min(max(__ldg(g.bstart + key0), 0),
                                         LN - 1));
            scanned = 1;
        }
    } else {
        const float hh = fmaxf(h, 1e-30f);
        const float h3 = hh * hh * hh;
        float carry = 0.0f;
        for (int t0 = 0; t0 < total; t0 += 32) {
            const int t = t0 + lane;
            float prob = 0.0f;
            int j = -1;
            if (t < total) {
                const int c = hash_grid::cell_at(s.pre, t);
                const int e = s.st[c] + (t - s.pre[c]);
                const float4 b0 = __ldg(g.rows + 2 * (int64_t)e);
                const float4 b1 = __ldg(g.rows + 2 * (int64_t)e + 1);
                j = __ldg(sorted_part + e);
                const float a = b1.w - floorf(b1.w / 8.0f) * 8.0f;
                const float d0 = hash_grid::min_image(b0.x - px, g.box);
                const float d1 = hash_grid::min_image(b0.y - py, g.box);
                const float d2 = hash_grid::min_image(b0.z - pz, g.box);
                const float r = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
                if ((int)a == type && r < h && j != i && !(b1.w >= 8.0f))
                    prob = pair_prob(r, hh, h3, vx - b0.w, vy - b1.x,
                                     vz - b1.y, b1.z, dt, sigma);
            }
            float x = prob;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float y = __shfl_up_sync(kFull, x, o);
                if (lane >= o) x += y;
            }
            const float cum = carry + x;
            const unsigned cross = __ballot_sync(kFull, prob > 0.0f
                                                 && cum >= u);
            if (cross) {
                const int f = __ffs(cross) - 1;
                pj = __shfl_sync(kFull, j, f);
                scanned = t0 + f + 1;
                break;
            }
            carry = __shfl_sync(kFull, cum, 31);
        }
    }
    if (lane == 0) {
        partner[i] = pj;
        hit[i] = pj >= 0 ? 1 : 0;
        need_out[i] = need;
        clip_out[i] = clip ? 1 : 0;
        scanned_out[i] = scanned;
    }
}

}  // namespace

// rows (LN, 8) [pos3 vel3 mass aux], sorted_part (LN,), bstart, bcount
// (L H,), geom (4,) [origin, s0]: the table; pos, vel (n, 3), hs, ptype,
// rand, dts (n,): the targets' predicted positions, velocities, search
// radii (SCAT_KERNEL_FACTOR hsml_vd), types, uniforms and dt_h0; tid (T,)
// the gated targets. Writes partner, hit, need, clip and scanned at the
// targets' rows only.
extern "C" int hash_scan_launch(const float* rows, const int* sorted_part,
                                int LN, const int* bstart, const int* bcount,
                                const float* geom, int L, int H, float box,
                                const float* pos, const float* vel,
                                const float* hs, const int* ptype,
                                const float* rand, const float* dts,
                                const int* tid, int T, int cap, int cs_type,
                                float sigma_co, float vc, float vel_scale,
                                float pow_law, int* partner, int* hit,
                                int* need, int* clip, int* scanned,
                                void* stream) {
    if (T <= 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    Grid g;
    g.rows = reinterpret_cast<const float4*>(rows);
    g.bstart = bstart;
    g.bcount = bcount;
    g.ox = g.oy = g.oz = g.s0 = 0.0f;   // read from geom by the kernel
    g.L = L;
    g.H = H;
    g.box = box;
    const Sigma sigma{cs_type, sigma_co, vc, vel_scale, pow_law};
    const int blocks = (T + kWarps - 1) / kWarps;
    hash_scan_kernel<<<blocks, 32 * kWarps, 0, st>>>(
        g, geom, sorted_part, LN, pos, vel, hs, ptype, rand, dts, tid, T, cap,
        sigma, partner, hit, need, clip, scanned);
    return (int)cudaGetLastError();
}
