// Spline-softened gravity kernels; h = 2.8 eps, Newtonian beyond h
// (forcetree.c:834, 1775-1789). softened_inv_r3 and softened_potential
// are evaluated in the order of sidm_tpu_torch/kernels.py so that the
// walk's far kernel rounds like the plain PyTorch version (far_kernel.cu is
// compiled with -fmad=false); rsqrt_fast and spline_soft are the
// division-free pair math of the near and list-far kernels (built with
// FMA).
#pragma once

#define SIDM_IMAX 2147483647

__device__ __forceinline__ float softened_inv_r3(float r, float h) {
    const float h_inv = 1.0f / h;
    const float u = r * h_inv;
    const float r_safe = fmaxf(r, 1e-37f);
    const float newton = 1.0f / (r_safe * r_safe * r_safe);
    const float uc = fminf(u, 1.0f);
    const float u2 = uc * uc;
    const float u3 = u2 * uc;
    float wf;
    if (uc < 0.5f) {
        wf = 32.0f * ((float)(1.0 / 3.0) - 1.2f * u2 + u3);
    } else {
        const float us = fmaxf(uc, 1e-12f);
        wf = 64.0f * ((float)(1.0 / 3.0) - 0.75f * uc + 0.6f * u2
                      - u3 / 6.0f)
             - (float)(1.0 / 15.0) / (us * us * us);
    }
    const float soft = wf * (h_inv * h_inv * h_inv);
    return (u >= 1.0f) ? newton : soft;
}

__device__ __forceinline__ float softened_potential(float r, float h) {
    const float h_inv = 1.0f / h;
    const float u = r * h_inv;
    const float r_safe = fmaxf(r, 1e-37f);
    const float newton = -1.0f / r_safe;
    const float uc = fminf(u, 1.0f);
    const float u2 = uc * uc;
    const float u4 = u2 * u2;
    float wp;
    if (uc < 0.5f) {
        wp = (float)(16.0 / 3.0) * u2 - 9.6f * u4 + 6.4f * u4 * uc - 2.8f;
    } else {
        const float us = fmaxf(uc, 1e-12f);
        wp = (float)(1.0 / 15.0) / us + (float)(32.0 / 3.0) * u2
             - 16.0f * u2 * uc + 9.6f * u4 - (float)(32.0 / 15.0) * u4 * uc
             - 3.2f;
    }
    const float soft = wp * h_inv;
    return (u >= 1.0f) ? newton : soft;
}

// rsqrt.approx (relative error below 2^-22.9), flushing subnormals: r^2 = 0
// (or subnormal) gives inf, which a caller only uses where r >= h.
__device__ __forceinline__ float rsqrt_fast(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The spline-softened force factor and potential inside the softening
// length (kernels.py; u = r / h < 1), without a division: h_inv = 1/h is
// given, and the outer branch's (1/15) / u^3 / h^3 is (1/15) / r^3 (ir3)
// and its (1/15) / u / h is (1/15) / r (ir). Both branches are FMA
// polynomials; the result is selected, so ir3 = inf at r = 0 (where
// u < 0.5) never reaches it.
template <bool POT>
__device__ __forceinline__ void spline_soft(float u, float hi, float ir,
                                            float ir3, float* fac,
                                            float* pot) {
    const float u2 = u * u;
    const float hi3 = hi * hi * hi;
    // 32 (1/3 - 1.2 u^2 + u^3)
    const float f_in = fmaf(u2, fmaf(32.0f, u, -38.4f), 32.0f / 3.0f);
    // 64 (1/3 - 0.75 u + 0.6 u^2 - u^3 / 6)
    const float f_out = fmaf(u, fmaf(u, fmaf(u, -32.0f / 3.0f, 38.4f),
                                     -48.0f), 64.0f / 3.0f);
    const bool inner = u < 0.5f;
    *fac = inner ? f_in * hi3 : fmaf(f_out, hi3, -(1.0f / 15.0f) * ir3);
    if (POT) {
        // 16/3 u^2 - 9.6 u^4 + 6.4 u^5 - 2.8
        const float p_in = fmaf(u2, fmaf(u2, fmaf(6.4f, u, -9.6f),
                                         16.0f / 3.0f), -2.8f);
        // 32/3 u^2 - 16 u^3 + 9.6 u^4 - 32/15 u^5 - 3.2
        const float p_out = fmaf(
            u2, fmaf(u, fmaf(u, fmaf(u, -32.0f / 15.0f, 9.6f), -16.0f),
                     32.0f / 3.0f), -3.2f);
        *pot = inner ? p_in * hi : fmaf(p_out, hi, (1.0f / 15.0f) * ir);
    }
}
