// The DSMC pair math shared by the gated tile (sidm_gated.cu) and the
// walk's segment pass (sidm_near.cu), so that both compute the same keys
// bit for bit: the pair hash and its Gumbel noise
// (sidm_tpu/ops/sidm_tree.py:_mix32, _pair_gumbel), the cubic-spline
// kernel (sidm_tpu/kernels.py:sph_kernel), sigma(v) v for cross-section
// types 0-4 (sidm_tpu/sidm_common.py:sigma_v_product), a pair's
// probability and key, the minimum image of a periodic box, and the
// squared-radius bound that stands in for a root in a pair loop (also
// used by the emission, sidm_emit.cu). Every including file builds with
// -fmad=false, so every product and sum is rounded as in the plain
// PyTorch versions.
#pragma once

#include <math.h>
#include <stdint.h>

namespace sidm_pair {

constexpr float kEightOverPi = 2.5464790894703255f;    // 8/pi
constexpr float kSixteenOverPi = 5.092958178940651f;   // 16/pi

__device__ __forceinline__ uint32_t mix32(uint32_t a, uint32_t b,
                                          uint32_t c) {
    uint32_t u = (a * 0x9E3779B1u) ^ (b * 0x85EBCA77u) ^ (c * 0xC2B2AE3Du);
    u ^= u >> 16;
    u *= 0x7FEB352Du;
    u ^= u >> 15;
    u *= 0x846CA68Bu;
    return u ^ (u >> 16);
}

__device__ __forceinline__ float pair_gumbel(uint32_t i, uint32_t j,
                                             uint32_t salt) {
    float uf = (float)(mix32(i, j, salt) >> 8) * (1.0f / 16777216.0f);
    uf = fminf(fmaxf(uf, 1e-7f), 0.99999988f);
    return -logf(-logf(uf));
}

__device__ __forceinline__ float sph_kernel(float u) {
    if (u >= 1.0f) return 0.0f;
    if (u < 0.5f)
        return kEightOverPi * (1.0f - 6.0f * u * u * (1.0f - u));
    const float om = 1.0f - u;
    return kSixteenOverPi * om * om * om;
}

// d - box*round(d/box) for box > 0 (rintf rounds half to even, as
// torch.round and jnp.round do; roundf would not), d itself for box 0.
__device__ __forceinline__ float min_image(float d, float box) {
    return box > 0.0f ? d - box * rintf(d / box) : d;
}

// The least float t >= 0 with sqrt_rn(t) >= r (0 when r <= 0 or NaN).
// The correctly rounded root is monotone, so for every float rr >= 0
// (and NaN) rr < t exactly when sqrt_rn(rr) < r: a pair loop that tests
// rr < t makes the decisions of one that takes every pair's root, and
// pays the root once per target. The two walks step one ULP at a time
// from r*r, which lies within a few ULPs of t.
__device__ __forceinline__ float sqrt_lt_bound(float r) {
    if (!(r > 0.0f)) return 0.0f;
    float t = __fmul_rn(r, r);
    while (t > 0.0f
           && __fsqrt_rn(__int_as_float(__float_as_int(t) - 1)) >= r)
        t = __int_as_float(__float_as_int(t) - 1);
    while (__fsqrt_rn(t) < r) t = __int_as_float(__float_as_int(t) + 1);
    return t;
}

struct Sigma {
    int type;
    float sigma_co, vc, vel_scale, pow_law;

    __device__ __forceinline__ float operator()(float rv) const {
        switch (type) {
            case 1:
                return sigma_co;
            case 2: {
                const float beta = rv / vc;
                const float v_dep = 1.0f / (1.0f + beta * beta);
                return sigma_co * rv * v_dep * v_dep;
            }
            case 3:
                return sigma_co * rv * powf(fmaxf(rv, 1e-30f) / vel_scale,
                                            pow_law);
            default:   // 0 hard sphere, 4 (angle by rejection later)
                return sigma_co * rv;
        }
    }
};

// P_j = 0.5 m_j W(r/h)/h^3 sigma(v) v dt of a pair at distance r < h
// (h floored at 1e-30, h3 = h*h*h) with relative velocity w.
__device__ __forceinline__ float pair_prob(float r, float h, float h3,
                                           float w0, float w1, float w2,
                                           float m, float dt,
                                           const Sigma& sigma) {
    const float wk = sph_kernel(r / h) / h3;
    const float rv = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
    return 0.5f * m * wk * sigma(rv) * dt;
}

// The Gumbel-max key log(max(P, 1e-37)) + Gumbel(i, j, salt) of a pair
// with P > 0.
__device__ __forceinline__ float pair_key(float prob, uint32_t i,
                                          uint32_t j, uint32_t salt) {
    return logf(fmaxf(prob, 1e-37f)) + pair_gumbel(i, j, salt);
}

}  // namespace sidm_pair
