// H5 and H6: SPH on the hash grid, the density sums and the hydro pair
// terms. Ports of sph_density's dens_block (sidm_tpu/ops/sph.py:112-135)
// and hydro_force's blk (:248-333), plain XLA in the JAX package (no Pallas
// original); see sidm_tpu_torch/ops/sph.py (sph_density_sums, hydro_pairs)
// for the contracts.
//
// Per query of radius h: the level of h and its 27 stencil buckets
// (hash_grid.cuh), each read up to cap rows; a row takes part when it has
// the query's type and r = |x_q - x_j| < max(h, 1e-30) (the minimum image
// in a periodic box).
//  H5: rho = sum m W(r/h)/h^3, divv = -sum m dW/h^4 / r (d . dv) and
//      rot = sum m dW/h^4 / r (d x dv) over r > 0, the neighbour count,
//      the stencil's largest bucket count (need), its level clip and the
//      rows read.
//  H6: for each row of another particle (j != the query's own id), the
//      dW(h_q) half of the symmetrised pressure and viscous force (Monaghan
//      viscosity, Balsara switch, limiter): gathered into the query's
//      accumulators when the query is active, scattered into the row's
//      particle with the query's mass when that is active.
// Every float32 term is rounded as in the plain version (-fmad=false, the
// same order of operations), so that the counts are its own; the terms are
// summed in float64 (warp sums, and for H6's accumulators atomic adds, in
// another order than the plain version's).
//
// Bound: operations (bounds.py: a row read 13, an H5 neighbour 51, an H6
// pair 92 with the float64 adds counted twice); the rows (H5 32 B, H6 48 B
// and the particle id) are read once per query, but neighbouring queries
// share most of their buckets, so they come mostly from L2 and bounds.py
// counts each distinct row once. Both run far below that bound (PERF.md):
// a query's reads depend on each other (stencil, bucket, row). Design: a
// warp a query, as hash_veldisp.cu: the 27 lanes of the stencil look up
// and dedupe their buckets, a prefix over the capped counts flattens
// (bucket, rank) into one slot range that the 32 lanes stripe, each lane
// keeps its own float64 partial sums and a shuffle tree adds them. H6's
// scatter half is one float64 atomicAdd per component a pair (native on
// sm_90).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_grid.cuh"
#include "sph_kernel.cuh"

namespace {

using hash_grid::Grid;
using hash_grid::kCells;
using hash_grid::kFull;

constexpr int kWarps = 8;           // queries a block
constexpr float kGamma = (float)(5.0 / 3.0);

struct WarpShared {
    int pre[kCells + 1];
    int st[kCells];
};

using sph_kernel::warp_sum;

__device__ __forceinline__ void load_geom(Grid& g, const float* geom) {
    g.ox = __ldg(geom);
    g.oy = __ldg(geom + 1);
    g.oz = __ldg(geom + 2);
    g.s0 = __ldg(geom + 3);
}

__global__ void __launch_bounds__(32 * kWarps)
sph_density_kernel(Grid g, const float* __restrict__ geom,
                   const float* __restrict__ pos_q,
                   const float* __restrict__ vel_q,
                   const int* __restrict__ type_q,
                   const float* __restrict__ h_q, int n, int cap,
                   int* __restrict__ cnt_out, double* __restrict__ rho_out,
                   double* __restrict__ divv_out,
                   double* __restrict__ rot_out, int* __restrict__ need_out,
                   int* __restrict__ clip_out,
                   int* __restrict__ scanned_out) {
    __shared__ WarpShared sh[kWarps];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int q = blockIdx.x * kWarps + w;
    if (q >= n) return;                 // whole warps only
    WarpShared& s = sh[w];
    load_geom(g, geom);
    const int64_t q3 = 3 * (int64_t)q;
    const float px = __ldg(pos_q + q3), py = __ldg(pos_q + q3 + 1),
                pz = __ldg(pos_q + q3 + 2);
    const float vx = __ldg(vel_q + q3), vy = __ldg(vel_q + q3 + 1),
                vz = __ldg(vel_q + q3 + 2);
    const int type = __ldg(type_q + q);
    const float h = __ldg(h_q + q);
    int count, start, key0;
    bool clip;
    hash_grid::stencil(g, px, py, pz, type, h, lane, &count, &start, &key0,
                       &clip);
    const int need = hash_grid::warp_max(count);
    const int total = hash_grid::stage_prefix(min(count, cap), lane, start,
                                              s.pre, s.st);
    const float hb = fmaxf(h, 1e-30f);
    const float hinv3 = 1.0f / (hb * hb * hb);
    const float hinv4 = hinv3 / hb;
    int c = 0;
    double rho = 0.0, divv = 0.0, r0 = 0.0, r1 = 0.0, r2s = 0.0;
    for (int t = lane; t < total; t += 32) {
        const int j = hash_grid::cell_at(s.pre, t);
        const int e = s.st[j] + (t - s.pre[j]);
        const float4 b0 = __ldg(g.rows + 2 * (int64_t)e);
        const float4 b1 = __ldg(g.rows + 2 * (int64_t)e + 1);
        const float a = b1.w - floorf(b1.w / 8.0f) * 8.0f;
        if ((int)a != type) continue;
        const float d0 = hash_grid::min_image(px - b0.x, g.box);
        const float d1 = hash_grid::min_image(py - b0.y, g.box);
        const float d2 = hash_grid::min_image(pz - b0.z, g.box);
        const float r = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        if (!(r < hb)) continue;
        const float u = r / hb;
        rho += (double)(b1.z * (sph_kernel::w(u) * hinv3));
        ++c;
        if (!(r > 0.0f)) continue;
        const float fac =
            b1.z * (sph_kernel::dw(u) * hinv4) / fmaxf(r, 1e-30f);
        const float e0 = vx - b0.w, e1 = vy - b1.x, e2 = vz - b1.y;
        divv -= (double)(fac * (d0 * e0 + d1 * e1 + d2 * e2));
        r0 += (double)(fac * (d1 * e2 - d2 * e1));
        r1 += (double)(fac * (d2 * e0 - d0 * e2));
        r2s += (double)(fac * (d0 * e1 - d1 * e0));
    }
    c = hash_grid::warp_sum(c);
    rho = warp_sum(rho);
    divv = warp_sum(divv);
    r0 = warp_sum(r0);
    r1 = warp_sum(r1);
    r2s = warp_sum(r2s);
    if (lane == 0) {
        cnt_out[q] = c;
        rho_out[q] = rho;
        divv_out[q] = divv;
        rot_out[q3] = r0;
        rot_out[q3 + 1] = r1;
        rot_out[q3 + 2] = r2s;
        need_out[q] = need;
        clip_out[q] = clip ? 1 : 0;
        scanned_out[q] = total;
    }
}

struct PairFactors {
    float alpha, alpha2;    // ArtBulkViscConst and 2 ArtBulkViscConst
    int comoving;
    float sqrt_a, hubble_a, time, prefac, fac_visc_fix, egy_fac;
};

__global__ void __launch_bounds__(32 * kWarps)
sph_hydro_kernel(Grid g, const float* __restrict__ geom,
                 const float4* __restrict__ wide,
                 const int* __restrict__ part,
                 const float* __restrict__ pos_q,
                 const float* __restrict__ vel_q,
                 const int* __restrict__ type_q,
                 const float* __restrict__ h_q,
                 const int* __restrict__ idx_q,
                 const float* __restrict__ qv, int n, int cap, PairFactors f,
                 double* __restrict__ acc, double* __restrict__ dt_egy,
                 int* __restrict__ pairs_out, int* __restrict__ need_out,
                 int* __restrict__ clip_out,
                 int* __restrict__ scanned_out) {
    __shared__ WarpShared sh[kWarps];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int q = blockIdx.x * kWarps + w;
    if (q >= n) return;                 // whole warps only
    WarpShared& s = sh[w];
    load_geom(g, geom);
    const int64_t q3 = 3 * (int64_t)q;
    const float px = __ldg(pos_q + q3), py = __ldg(pos_q + q3 + 1),
                pz = __ldg(pos_q + q3 + 2);
    const float vx = __ldg(vel_q + q3), vy = __ldg(vel_q + q3 + 1),
                vz = __ldg(vel_q + q3 + 2);
    const int type = __ldg(type_q + q);
    const float h = __ldg(h_q + q);
    const int iq = __ldg(idx_q + q);
    const float* v = qv + 8 * (int64_t)q;
    const float rho_q = __ldg(v), csnd_q = __ldg(v + 1),
                fb_q = __ldg(v + 2), m_q = __ldg(v + 3),
                por2_q = __ldg(v + 4), dt_q = __ldg(v + 5);
    const bool act_q = __ldg(v + 6) > 0.0f;
    int count, start, key0;
    bool clip;
    hash_grid::stencil(g, px, py, pz, type, h, lane, &count, &start, &key0,
                       &clip);
    const int need = hash_grid::warp_max(count);
    const int total = hash_grid::stage_prefix(min(count, cap), lane, start,
                                              s.pre, s.st);
    const float hb = fmaxf(h, 1e-30f);
    const float h2 = hb * hb;
    const float h4 = h2 * h2;
    const float half = f.prefac * 0.5f;
    const float half_egy = 0.5f * f.egy_fac;
    int np = 0;
    double ax = 0.0, ay = 0.0, az = 0.0, de = 0.0;
    for (int t = lane; t < total; t += 32) {
        const int j = hash_grid::cell_at(s.pre, t);
        const int e = s.st[j] + (t - s.pre[j]);
        const float4 b0 = __ldg(wide + 3 * (int64_t)e);
        const float4 b1 = __ldg(wide + 3 * (int64_t)e + 1);
        const float a = b1.w - floorf(b1.w / 8.0f) * 8.0f;
        if ((int)a != type) continue;
        const int c = __ldg(part + e);
        if (c == iq) continue;
        const float d0 = hash_grid::min_image(px - b0.x, g.box);
        const float d1 = hash_grid::min_image(py - b0.y, g.box);
        const float d2 = hash_grid::min_image(pz - b0.z, g.box);
        const float r2 = d0 * d0 + d1 * d1 + d2 * d2;
        const float r = sqrtf(r2);
        if (!(r < hb)) continue;
        ++np;
        const float4 b2 = __ldg(wide + 3 * (int64_t)e + 2);
        const float dwk = sph_kernel::dw(r / hb) / h4;
        const float e0 = vx - b0.w, e1 = vy - b1.x, e2 = vz - b1.y;
        float vdotr2 = d0 * e0 + d1 * e1 + d2 * e2;
        if (f.comoving) vdotr2 = vdotr2 / f.sqrt_a + f.hubble_a * r2;
        const float h_ij = 0.5f * (h + b2.x);
        const float c_ij = 0.5f * (csnd_q + b2.z);
        const float rho_ij = 0.5f * (rho_q + b2.y);
        float mu = h_ij * vdotr2 / (r2 + 0.01f * h_ij * h_ij);
        if (f.comoving) mu = mu * f.time;
        float visc = 0.0f;
        if (vdotr2 < 0.0f) {
            visc = (-f.alpha * mu * c_ij + f.alpha2 * mu * mu)
                   / fmaxf(rho_ij, 1e-30f) * 0.5f * (fb_q + b2.w);
            if (dt_q > 0.0f && dwk < 0.0f) {
                const float msum = 0.5f * (m_q + b1.z);
                const float lim = f.fac_visc_fix * vdotr2
                                  / (msum * (2.0f * dwk) * fmaxf(r, 1e-30f)
                                     * fmaxf(dt_q, 1e-30f));
                visc = fminf(visc, lim);
            }
        }
        const float rho_c = fmaxf(b2.y, 1e-30f);
        const float por2_c = b2.z * b2.z / (kGamma * rho_c);
        const float pp = 2.0f * sqrtf(fmaxf(por2_q * por2_c, 0.0f));
        const float r_safe = fmaxf(r, 1e-30f);
        if (act_q) {
            const float hfc = half * b1.z * (pp + visc) * dwk / r_safe;
            ax -= (double)(hfc * d0);
            ay -= (double)(hfc * d1);
            az -= (double)(hfc * d2);
            de += (double)(half_egy * hfc * vdotr2);
        }
        if (b1.w >= 8.0f) {
            const float hfc_c = half * m_q * (pp + visc) * dwk / r_safe;
            double* ac = acc + 3 * (int64_t)c;
            atomicAdd(ac, (double)(hfc_c * d0));
            atomicAdd(ac + 1, (double)(hfc_c * d1));
            atomicAdd(ac + 2, (double)(hfc_c * d2));
            atomicAdd(dt_egy + c, (double)(half_egy * hfc_c * vdotr2));
        }
    }
    np = hash_grid::warp_sum(np);
    if (act_q) {
        ax = warp_sum(ax);
        ay = warp_sum(ay);
        az = warp_sum(az);
        de = warp_sum(de);
        if (lane == 0) {
            double* aq = acc + 3 * (int64_t)iq;
            atomicAdd(aq, ax);
            atomicAdd(aq + 1, ay);
            atomicAdd(aq + 2, az);
            atomicAdd(dt_egy + iq, de);
        }
    }
    if (lane == 0) {
        pairs_out[q] = np;
        need_out[q] = need;
        clip_out[q] = clip ? 1 : 0;
        scanned_out[q] = total;
    }
}

Grid make_grid(const float* rows, const int* bstart, const int* bcount,
               int L, int H, float box) {
    Grid g;
    g.rows = reinterpret_cast<const float4*>(rows);
    g.bstart = bstart;
    g.bcount = bcount;
    g.ox = g.oy = g.oz = g.s0 = 0.0f;   // read from geom by the kernels
    g.L = L;
    g.H = H;
    g.box = box;
    return g;
}

}  // namespace

// H5. rows (LN, 8) float32 [pos3 vel3 mass aux] in sorted entry order;
// bstart, bcount (L H,) int32; geom (4,) float32 [origin, s0]; pos_q,
// vel_q (n, 3), type_q, h_q (n,); outputs (n,): count, rho and divv
// (float64), rot (n, 3) float64, need, clip, rows read.
extern "C" int sph_density_launch(const float* rows, const int* bstart,
                                  const int* bcount, const float* geom,
                                  int L, int H, float box,
                                  const float* pos_q, const float* vel_q,
                                  const int* type_q, const float* h_q, int n,
                                  int cap, int* cnt_out, double* rho_out,
                                  double* divv_out, double* rot_out,
                                  int* need_out, int* clip_out,
                                  int* scanned_out, void* stream) {
    if (n <= 0) return 0;
    const Grid g = make_grid(rows, bstart, bcount, L, H, box);
    const int blocks = (n + kWarps - 1) / kWarps;
    sph_density_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        g, geom, pos_q, vel_q, type_q, h_q, n, cap, cnt_out, rho_out,
        divv_out, rot_out, need_out, clip_out, scanned_out);
    return (int)cudaGetLastError();
}

// H6. wide (LN, 12) float32 [pos3 vel3 mass aux h rho csnd f_balsara]
// (aux = type + 8 active) in sorted entry order, part (LN,) its particle
// ids; bstart, bcount, geom as H5; the queries' pos_q, vel_q (nq, 3),
// type_q, h_q, idx_q (their particle ids) (nq,) and qv (nq, 8) [rho, csnd,
// f_balsara, mass, P/rho^2, dt, active, 0]; the pair factors; acc (N, 3)
// and dt_egy (N,) float64 accumulators, added to; per query its pairs,
// need, clip and rows read.
extern "C" int sph_hydro_launch(const float* wide, const int* part,
                                const int* bstart, const int* bcount,
                                const float* geom, int L, int H, float box,
                                const float* pos_q, const float* vel_q,
                                const int* type_q, const float* h_q,
                                const int* idx_q, const float* qv, int n,
                                int cap, float alpha, float alpha2,
                                int comoving, float sqrt_a, float hubble_a,
                                float time, float prefac, float fac_visc_fix,
                                float egy_fac, double* acc, double* dt_egy,
                                int* pairs_out, int* need_out, int* clip_out,
                                int* scanned_out, void* stream) {
    if (n <= 0) return 0;
    // H6 reads the 12-float rows through ``wide``; the stencil reads only
    // the bucket tables, so the grid's row pointer is not read
    const Grid g = make_grid(wide, bstart, bcount, L, H, box);
    PairFactors f;
    f.alpha = alpha;
    f.alpha2 = alpha2;
    f.comoving = comoving;
    f.sqrt_a = sqrt_a;
    f.hubble_a = hubble_a;
    f.time = time;
    f.prefac = prefac;
    f.fac_visc_fix = fac_visc_fix;
    f.egy_fac = egy_fac;
    const int blocks = (n + kWarps - 1) / kWarps;
    sph_hydro_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        g, geom, reinterpret_cast<const float4*>(wide), part, pos_q, vel_q,
        type_q, h_q, idx_q, qv, n, cap, f, acc, dt_egy, pairs_out, need_out,
        clip_out, scanned_out);
    return (int)cudaGetLastError();
}
