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

template <bool POT>
__global__ void __launch_bounds__(kThreads)
far_list_kernel(const float* __restrict__ tbl, int nrows,
                const int* __restrict__ ids, const int* __restrict__ nf,
                int LF, int ng, const int* __restrict__ unit,
                const int* __restrict__ off,
                const int* __restrict__ item_g,
                const float* __restrict__ xc, const float* __restrict__ te,
                const float* __restrict__ gc, float* __restrict__ part) {
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
    const float gc0 = gc[g * 3 + 0], gc1 = gc[g * 3 + 1],
                gc2 = gc[g * 3 + 2];
    const float x0 = xc[(g * kG + t) * 3 + 0];
    const float x1 = xc[(g * kG + t) * 3 + 1];
    const float x2 = xc[(g * kG + t) * 3 + 2];
    const float hit = 1.0f / (2.8f * te[g * kG + t]);
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
            st[1] = make_float4(1.0f / (2.8f * r3.z), r2.x, r2.y, r2.z);
            st[2] = make_float4(r2.w, r3.x, r3.y, 0.0f);
        }
        __syncthreads();
        // the next chunk's rows load while this one computes
        ok = load_row(tbl, nrows, ids_g, c0 + kThreads + tid, e1, &r0,
                      &r2, &r3);
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

extern "C" int far_list_launch(const float* tbl, int nrows, const int* ids,
                               const int* nf, int ng, int LF,
                               const float* xc, const float* te,
                               const float* gc, int need_pot, float* acc,
                               int* ws, int icap, float* part, void* stream) {
    if (ng <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const items::Ws w = items::ws_of(ws, ng, icap, false);
    int err = split(nf, ng, LF, w, icap, st);
    if (err) return err;
    auto kern = need_pot ? far_list_kernel<true> : far_list_kernel<false>;
    kern<<<icap, kThreads, 0, st>>>(tbl, nrows, ids, nf, LF, ng, w.unit, w.off,
                                    w.item_g, xc, te, gc, part);
    if ((err = (int)cudaGetLastError())) return err;
    items::items_fold<<<ng, 256, 0, st>>>(w.off, items::ItemsSum{part, acc});
    return (int)cudaGetLastError();
}
