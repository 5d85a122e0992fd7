// The SPH cubic spline W(u) and its derivative dW/du of
// sidm_tpu_torch/kernels.py (sph_kernel, sph_kernel_deriv), each product in
// its order (the sources that include this build with -fmad=false); 0 for
// u >= 1. Shared by the hash grid's SPH kernels (hash_sph.cu) and the
// tree's (tree_sph.cu).
#pragma once

namespace sph_kernel {

__device__ __forceinline__ float w(float u) {
    const float c = (float)(8.0 / 3.14159265358979323846);
    const float c2 = (float)(2.0 * (8.0 / 3.14159265358979323846));
    const float inner = c * (1.0f - 6.0f * u * u * (1.0f - u));
    const float om = 1.0f - u;
    const float outer = c2 * om * om * om;
    const float v = u < 0.5f ? inner : outer;
    return u < 1.0f ? v : 0.0f;
}

__device__ __forceinline__ float dw(float u) {
    const float c = (float)(8.0 / 3.14159265358979323846);
    const float inner = c * (-12.0f * u + 18.0f * u * u);
    const float om = 1.0f - u;
    const float outer = c * (-6.0f * om * om);
    const float d = u < 0.5f ? inner : outer;
    return u < 1.0f ? d : 0.0f;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

}  // namespace sph_kernel
