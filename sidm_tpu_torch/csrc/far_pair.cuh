// Group-centred monopole + Newtonian-range quadrupole of one node on one
// target, accumulated as per-chunk sums and folded into [ax ay az pot] in
// the Pallas far kernel's combination order (pallas_far.py:116-176, the
// math of fused_force.far_tile), for far_kernel.cu (the walk's far pass;
// the cached lists' far pass has its own routine in far_list.cu).
// far_kernel.cu is compiled with -fmad=false, so each product and sum
// rounds as in the plain PyTorch version.
//
// Operations the function needs, counted from far_pair below on the
// Newtonian branch that far pairs take (each add, multiply, min/max,
// compare, division and square root as one): per (target, node) pair 24
// for the monopole (1/r^3 only, not the softened polynomial) and 51 for the
// quadrupole, 5 more with the potential; per (group, node) entry 25 for the
// quantities that do not depend on the target (|c|^2, Q c, c.Q c), which
// far_pair recomputes for every target. sidm_tpu_torch/bounds.py holds
// these counts.
#pragma once

#include "softening.cuh"

// One staged node: group-centred COM xyz, mass, eps, quadrupole (6).
constexpr int kStage = 11;

struct FarAcc {
    float fsum, sfc[3], pot, w5u[3], mw[6], t7sum, st7c[3], pq;
};

__device__ __forceinline__ void far_pair(FarAcc& a, const float* nd,
                                         float x0, float x1, float x2,
                                         float nx2, float tet, bool need_pot) {
    const float c0 = nd[0], c1 = nd[1], c2 = nd[2];
    const float m = nd[3], epsn = nd[4];
    const float ny2 = c0 * c0 + c1 * c1 + c2 * c2;
    const float cross = x0 * c0 + x1 * c1 + x2 * c2;
    const float r2 = fmaxf(nx2 + ny2 - 2.0f * cross, 0.0f);
    const float r = sqrtf(r2);
    const float h = 2.8f * fmaxf(tet, epsn);
    const float fac = m * softened_inv_r3(r, h);
    a.fsum += fac;
    a.sfc[0] += fac * c0;
    a.sfc[1] += fac * c1;
    a.sfc[2] += fac * c2;
    if (need_pot) a.pot += m * softened_potential(r, h);
    // quadrupole, Newtonian range only (forcetree.c:1002-1060)
    if (!((r >= h) && (m > 0.0f))) return;
    const float ir = 1.0f / fmaxf(r, 1e-30f);
    const float ir2 = ir * ir;
    const float w5 = ir2 * ir2 * ir;
    const float w7 = w5 * ir2;
    const float q0 = nd[5], q1 = nd[6], q2 = nd[7];
    const float q3 = nd[8], q4 = nd[9], q5 = nd[10];
    const float u0 = q0 * c0 + q3 * c1 + q4 * c2;
    const float u1 = q3 * c0 + q1 * c1 + q5 * c2;
    const float u2 = q4 * c0 + q5 * c1 + q2 * c2;
    const float s = u0 * c0 + u1 * c1 + u2 * c2;
    const float xu = x0 * u0 + x1 * u1 + x2 * u2;
    const float xqx = x0 * x0 * q0 + x1 * x1 * q1 + x2 * x2 * q2
                      + 2.0f * x0 * x1 * q3 + 2.0f * x0 * x2 * q4
                      + 2.0f * x1 * x2 * q5;
    const float dqd = s - 2.0f * xu + xqx;
    a.w5u[0] += w5 * u0;
    a.w5u[1] += w5 * u1;
    a.w5u[2] += w5 * u2;
    a.mw[0] += w5 * q0;
    a.mw[1] += w5 * q1;
    a.mw[2] += w5 * q2;
    a.mw[3] += w5 * q3;
    a.mw[4] += w5 * q4;
    a.mw[5] += w5 * q5;
    const float t7 = w7 * dqd;
    a.t7sum += t7;
    a.st7c[0] += t7 * c0;
    a.st7c[1] += t7 * c1;
    a.st7c[2] += t7 * c2;
    if (need_pot) a.pq += dqd * w5;
}

// One chunk's sums -> [ax ay az pot], in the Pallas kernel's combination
// order, added to the running totals.
__device__ __forceinline__ void far_combine(float* out, const FarAcc& a,
                                            float x0, float x1, float x2) {
    const float xs[3] = {x0, x1, x2};
    const float qxv[3] = {a.mw[0] * x0 + a.mw[3] * x1 + a.mw[4] * x2,
                          a.mw[3] * x0 + a.mw[1] * x1 + a.mw[5] * x2,
                          a.mw[4] * x0 + a.mw[5] * x1 + a.mw[2] * x2};
#pragma unroll
    for (int d = 0; d < 3; ++d)
        out[d] += (a.sfc[d] - xs[d] * a.fsum) - a.w5u[d] + qxv[d]
                  + 2.5f * (a.st7c[d] - xs[d] * a.t7sum);
    out[3] += a.pot - 0.5f * a.pq;
}

// Stage a packed node row (pack_tree layout) relative to the group centre.
__device__ __forceinline__ void far_stage(float* st, const float* row,
                                          float gc0, float gc1, float gc2) {
    st[0] = row[0] - gc0;
    st[1] = row[1] - gc1;
    st[2] = row[2] - gc2;
    st[3] = row[3];
    st[4] = row[14];
#pragma unroll
    for (int k = 0; k < 6; ++k) st[5 + k] = row[8 + k];
}
