// Far field of recorded (node, target-group) pairs: the far pass of the
// cached interaction lists (sidm_tpu/ops/list_force.py _eval :604-654,
// gather form), and the port of scripts/pallasfar.py:far_kernel (see
// sidm_tpu_torch/ops/far_list.py for the contract).
//
// What bounds it on the H100: the pair math (~6e8 (target, node) pairs per
// evaluation of the flagship's lists, monopole + quadrupole each). The
// design spends few instructions per pair and spreads long lists:
//   * items_plan (work_items.cuh) cuts each group's list into work items
//     of about equal entry count; far_list_kernel runs one block per item;
//     items_fold (items::ItemsSum) adds each group's item slots in item
//     order (no float atomics, the same result from run to run).
//   * Per 256-entry chunk each thread gathers one row by id from the
//     compact table (three 16-byte loads; the table stays in the 50 MB
//     L2), dead entries (ids out of range, the zero row) are dropped by a
//     warp ballot, and the kept rows are staged in shared memory,
//     group-centred, with the node's 1/(2.8 eps), as three float4 that a
//     warp reads as broadcasts. The next chunk's rows are loaded into
//     registers while the current chunk computes.
//   * 64 targets x 4 entry slices per block, the slices added in shared
//     memory in a fixed order.
//   * The pair is formed on d = c - x, not on the plain version's
//     expansion |x|^2 + |c|^2 - 2 x.c: the quadrupole term
//     -w5 Q d + 2.5 w7 (d.Q.d) d needs Q d (9 FMA) and d.Q.d (3), fewer
//     instructions per pair than the expansion's x.u, x.Q.x and the per
//     chunk sums (u = Q c, c.Q.c and |c|^2 would be the per-entry work of
//     that form; this form has none beyond the centring and 1/(2.8 eps)),
//     and it does not cancel. 1/r comes from rsqrt.approx, and the
//     Newtonian range that nearly every far pair takes is all FMA; the
//     softened monopole (softening.cuh spline_soft) runs only where a
//     lane needs it. This source is built with FMA.
//
// Periodic mode (PBC, the walk's far field in a TreePM box; port of
// sidm_tpu/ops/fused_force.py:_far_tile_pbc :488-578, which JAX's periodic
// walk runs in XLA): the rows are staged raw (com, mass | 2.8 eps, q0-q2 |
// q3-q5, the raw quadrupole trace from trq), and each pair vector is the
// minimum image of com - x from the raw target, d - box rint(d / box)
// (half to even, as torch.round). Beyond rcut a pair adds nothing. The
// monopole is m softened_inv_r3(r, h) S(r), S = erfc(a r) + (2/sqrt(pi))
// a r exp(-a^2 r^2) by erfcf and expf; the potential m
// pm.short_range_pot (-erfc(a r) / r beyond the softening); on the Newtonian
// range the exact screened quadrupole with E = (2a/sqrt(pi)) exp(-a^2
// r^2): -cA (dQd + tr r^2) d - cB Q d - 2.5 cB tr d, cA = -(2/3) a^4 E /r^2
// - (5/3) a^2 E / r^4 - 2.5 S / r^7, cB = (2/3) a^2 E / r^2 + S / r^5 (the
// Gaussian term dominates near rcut). The pair math uses IEEE division
// and sqrt (softening.cuh's softened_inv_r3 / softened_potential) instead
// of the Newtonian path's rsqrt: the screened pair is dominated by erfcf
// and expf anyway. erfcf, erff and expf differ from torch's by a few ULP,
// inside the 2e-5 bar chip_smoke.py holds it to.
#include <cuda_runtime.h>
#include <stdint.h>

#include "softening.cuh"
#include "work_items.cuh"

namespace {

constexpr int kG = 64;               // targets per group
constexpr int kThreads = 256;        // == list entries per chunk
constexpr int kSlices = kThreads / kG;
constexpr int kEMin = 256;           // least list entries per item

struct FarSmem {
    float4 row[kThreads][3];         // c m | hinv q0 q1 q2 | q3 q4 q5 -
                                     // (PBC: c m | h q0 q1 q2 | q3 q4 q5 tr)
    int wcnt[kThreads / 32];
    float red[kSlices - 1][kG][4];
};

// The packed row (pack_tree layout: com 0-2, mass 3, quadrupole 8-13,
// eps 14) of list entry e, or ok = false for a dead entry.
__device__ __forceinline__ bool load_row(const float* tbl, int nrows,
                                         const int* ids_g, int e, int e1,
                                         float4* r0, float4* r2,
                                         float4* r3) {
    if (e >= e1) return false;
    const int id = ids_g[e];
    if (id < 0 || id >= nrows) return false;
    const float4* src = reinterpret_cast<const float4*>(tbl) + (int64_t)id * 4;
    *r0 = __ldg(src + 0);
    *r2 = __ldg(src + 2);
    *r3 = __ldg(src + 3);
    return true;
}

struct Pbc {
    const float* trq;                // (nrows,) raw quadrupole traces
    float box, alpha, rcut;
};

__device__ __forceinline__ float min_image(float d, float box) {
    return d - box * rintf(d / box);
}

// One periodic (target, node) pair (see the note at the top): adds the
// screened monopole and quadrupole to a and the potential to pot.
template <bool POT>
__device__ __forceinline__ void pbc_pair(const float4& A, const float4& B,
                                         const float4& C, float x0,
                                         float x1, float x2, float ht,
                                         const Pbc& pb, float* a,
                                         float* pot) {
    constexpr float kTwoOverSqrtPi = 1.1283791670955126f;
    const float d0 = min_image(A.x - x0, pb.box);
    const float d1 = min_image(A.y - x1, pb.box);
    const float d2 = min_image(A.z - x2, pb.box);
    const float r2 = d0 * d0 + d1 * d1 + d2 * d2;
    const float r = sqrtf(r2);
    if (!(r <= pb.rcut)) return;
    const float h = fmaxf(ht, B.x);
    const float x = pb.alpha * r;
    const float ex = expf(-x * x);
    const float S = erfcf(x) + kTwoOverSqrtPi * x * ex;
    const float fac = A.w * softened_inv_r3(r, h) * S;
    float ax = fac * d0, ay = fac * d1, az = fac * d2;
    if (POT) {
        // pm.short_range_pot: -erfc(a r) / r beyond the softening
        float p;
        if (r >= h) {
            p = -erfcf(x) / fmaxf(r, 1e-30f);
        } else {
            const float xs = fmaxf(x, 1e-12f);
            p = softened_potential(r, h)
                + (x < 0.1f ? pb.alpha * kTwoOverSqrtPi * (1.0f - x * x / 3.0f)
                            : erff(xs) / fmaxf(r, 1e-30f));
        }
        *pot += A.w * p;
    }
    if (r >= h && A.w > 0.0f) {
        const float ir = 1.0f / fmaxf(r, 1e-30f);
        const float ir2 = ir * ir;
        const float a2 = pb.alpha * pb.alpha;
        const float E = pb.alpha * kTwoOverSqrtPi * expf(-a2 * r2);
        const float ir5 = ir2 * ir2 * ir;
        const float cA = -(2.0f / 3.0f) * a2 * a2 * E * ir2
                         - (5.0f / 3.0f) * a2 * E * ir2 * ir2
                         - 2.5f * S * ir2 * ir5;
        const float cB = (2.0f / 3.0f) * a2 * E * ir2 + S * ir5;
        const float u0 = B.y * d0 + C.x * d1 + C.y * d2;
        const float u1 = C.x * d0 + B.z * d1 + C.z * d2;
        const float u2 = C.y * d0 + C.z * d1 + B.w * d2;
        const float dqd = d0 * u0 + d1 * u1 + d2 * u2;
        const float tr = C.w;
        const float tA = -cA * (dqd + tr * r2) - 2.5f * cB * tr;
        ax += tA * d0 - cB * u0;
        ay += tA * d1 - cB * u1;
        az += tA * d2 - cB * u2;
        if (POT)
            *pot += 0.5f * tr * S * ir2 * ir
                    - (dqd + tr * r2) * ((1.0f / 3.0f) * a2 * E * ir2
                                         + 0.5f * S * ir5);
    }
    a[0] += ax;
    a[1] += ay;
    a[2] += az;
}

template <bool POT, bool PBC>
__global__ void __launch_bounds__(kThreads)
far_list_kernel(const float* __restrict__ tbl, int nrows,
                const int* __restrict__ ids, const int* __restrict__ nf,
                int LF, int ng, const int* __restrict__ unit,
                const int* __restrict__ off,
                const int* __restrict__ item_g,
                const float* __restrict__ xc, const float* __restrict__ te,
                const float* __restrict__ gc, float* __restrict__ part,
                const Pbc pb) {
    __shared__ FarSmem sm;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int t = tid & (kG - 1);
    const int slice = tid / kG;
    const int it = blockIdx.x;
    if (it >= off[ng]) return;
    const int g = item_g[it];
    const int E = unit[g];
    const int w = min(max(nf[g], 0), LF);
    const int e0 = (it - off[g]) * E;
    const int e1 = min(e0 + E, w);
    const int* ids_g = ids + (int64_t)g * LF;
    // PBC: xc holds the raw targets and the rows stay raw
    const float gc0 = PBC ? 0.0f : gc[g * 3 + 0];
    const float gc1 = PBC ? 0.0f : gc[g * 3 + 1];
    const float gc2 = PBC ? 0.0f : gc[g * 3 + 2];
    const float x0 = xc[(g * kG + t) * 3 + 0];
    const float x1 = xc[(g * kG + t) * 3 + 1];
    const float x2 = xc[(g * kG + t) * 3 + 2];
    const float hit = 1.0f / (2.8f * te[g * kG + t]);
    const float ht = 2.8f * te[g * kG + t];
    float ax = 0.0f, ay = 0.0f, az = 0.0f, pot = 0.0f;

    float4 r0, r2, r3;
    bool ok = load_row(tbl, nrows, ids_g, e0 + tid, e1, &r0, &r2, &r3);
    for (int c0 = e0; c0 < e1; c0 += kThreads) {
        const bool keep = ok && r0.w != 0.0f;
        const unsigned ball = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) sm.wcnt[warp] = __popc(ball);
        __syncthreads();
        int pos = 0, total = 0;
#pragma unroll
        for (int k = 0; k < kThreads / 32; ++k) {
            pos += (k < warp) ? sm.wcnt[k] : 0;
            total += sm.wcnt[k];
        }
        if (keep) {
            float4* st = sm.row[pos + __popc(ball & ((1u << lane) - 1u))];
            st[0] = make_float4(r0.x - gc0, r0.y - gc1, r0.z - gc2, r0.w);
            if (PBC) {
                st[1] = make_float4(2.8f * r3.z, r2.x, r2.y, r2.z);
                st[2] = make_float4(r2.w, r3.x, r3.y,
                                    __ldg(pb.trq + ids_g[c0 + tid]));
            } else {
                st[1] = make_float4(1.0f / (2.8f * r3.z), r2.x, r2.y, r2.z);
                st[2] = make_float4(r2.w, r3.x, r3.y, 0.0f);
            }
        }
        __syncthreads();
        // the next chunk's rows load while this one computes
        ok = load_row(tbl, nrows, ids_g, c0 + kThreads + tid, e1, &r0,
                      &r2, &r3);
        if (PBC) {
            float a3[3] = {ax, ay, az};
            for (int k = slice; k < total; k += kSlices)
                pbc_pair<POT>(sm.row[k][0], sm.row[k][1], sm.row[k][2], x0,
                              x1, x2, ht, pb, a3, &pot);
            ax = a3[0];
            ay = a3[1];
            az = a3[2];
            __syncthreads();     // the stage is refilled next
            continue;
        }
#pragma unroll 2
        for (int k = slice; k < total; k += kSlices) {
            const float4 A = sm.row[k][0];
            const float4 B = sm.row[k][1];
            const float d0 = A.x - x0, d1 = A.y - x1, d2 = A.z - x2;
            const float r2s = fmaf(d2, d2, fmaf(d1, d1, d0 * d0));
            const float hp = fminf(hit, B.x);
            const float ir = rsqrt_fast(fmaxf(r2s, 1e-37f));
            const float ir2 = ir * ir;
            const float ir3 = ir2 * ir;
            if (r2s * (hp * hp) >= 1.0f) {
                // Newtonian range: monopole + quadrupole
                const float4 C = sm.row[k][2];
                const float qd0 = fmaf(C.y, d2, fmaf(C.x, d1, B.y * d0));
                const float qd1 = fmaf(C.z, d2, fmaf(B.z, d1, C.x * d0));
                const float qd2 = fmaf(B.w, d2, fmaf(C.z, d1, C.y * d0));
                const float dqd = fmaf(d2, qd2, fmaf(d1, qd1, d0 * qd0));
                const float w5 = ir3 * ir2;
                const float w7 = w5 * ir2;
                const float coef = fmaf(2.5f * w7, dqd, A.w * ir3);
                ax = fmaf(-w5, qd0, fmaf(coef, d0, ax));
                ay = fmaf(-w5, qd1, fmaf(coef, d1, ay));
                az = fmaf(-w5, qd2, fmaf(coef, d2, az));
                if (POT) pot = fmaf(-0.5f * w5, dqd, fmaf(-A.w, ir, pot));
            } else {
                float fac, ph;
                spline_soft<POT>(r2s * ir * hp, hp, ir, ir3, &fac, &ph);
                fac *= A.w;
                ax = fmaf(fac, d0, ax);
                ay = fmaf(fac, d1, ay);
                az = fmaf(fac, d2, az);
                if (POT) pot = fmaf(A.w, ph, pot);
            }
        }
        __syncthreads();         // the stage is refilled next
    }

    items::store_item<kSlices, POT>(sm.red, part, it, ax, ay, az, pot);
}

int split(const int* nf, int ng, int LF, const items::Ws& w, int icap,
          cudaStream_t st) {
    items::items_plan<<<1, items::kPlanThreads, 0, st>>>(
        nf, LF, ng, icap, kEMin, w.unit, w.off, w.item_g);
    return (int)cudaGetLastError();
}

}  // namespace

// The work items alone (for checks): fills the workspace.
extern "C" int far_split_launch(const int* nf, int ng, int LF, int* ws,
                                int icap, void* stream) {
    if (ng <= 0) return 0;
    return split(nf, ng, LF, items::ws_of(ws, ng, icap, false), icap,
                 (cudaStream_t)stream);
}

// periodic = 1: the periodic mode (xc the raw targets, gc not read; trq
// (nrows,) the rows' raw quadrupole traces; box, alpha, rcut the split).
extern "C" int far_list_launch(const float* tbl, int nrows, const int* ids,
                               const int* nf, int ng, int LF,
                               const float* xc, const float* te,
                               const float* gc, int need_pot, float* acc,
                               int* ws, int icap, float* part,
                               const float* trq, float box, float alpha,
                               float rcut, int periodic, void* stream) {
    if (ng <= 0) return 0;
    if (periodic && !trq) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const items::Ws w = items::ws_of(ws, ng, icap, false);
    int err = split(nf, ng, LF, w, icap, st);
    if (err) return err;
    auto kern = periodic
        ? (need_pot ? far_list_kernel<true, true>
                    : far_list_kernel<false, true>)
        : (need_pot ? far_list_kernel<true, false>
                    : far_list_kernel<false, false>);
    const Pbc pb{trq, box, alpha, rcut};
    kern<<<icap, kThreads, 0, st>>>(tbl, nrows, ids, nf, LF, ng, w.unit, w.off,
                                    w.item_g, xc, te, gc, part, pb);
    if ((err = (int)cudaGetLastError())) return err;
    items::items_fold<<<ng, 256, 0, st>>>(w.off, items::ItemsSum{part, acc});
    return (int)cudaGetLastError();
}
