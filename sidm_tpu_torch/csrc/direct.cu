// H3: the direct-summation gravity of ForceMethod direct (non-periodic):
// every source on every target. Port of sidm_tpu/ops/direct.py:
// direct_gravity (:33-105), plain XLA in the JAX package (no Pallas
// original); see sidm_tpu_torch/ops/direct.py for the contract.
//
// Per pair: d = x_j - x_i, r = |d|, h = 2.8 max(eps_i, eps_j); the spline
// softened force factor and potential for r < h (kernels.py:52,67,
// evaluated by softening.cuh's division-free polynomials) and 1/r^3, -1/r
// beyond; acc_i += m_j f d and pot_i += m_j phi (the self-potential term
// m_i / eps_i is the wrapper's). A self pair has d = 0 and adds nothing to
// the force, -2.8 m_i / h_ii to the potential (as in the plain version).
//
// Design: one target a thread, 256 a block; the sources pass through
// shared memory in tiles of 256 (position and mass as a float4, 2.8 eps
// beside it). Each tile's sums are taken in float32 and added to float64
// accumulators, so the result's rounding error does not grow with N: the
// kernel is held to the plain version (whose chunked float32 sums carry
// their own) at p99.9 relative error < 1e-5. Built with FMA.
//
// Periodic mode (PBC: sidm_tpu/ops/direct.py's periodic branch, _min_image
// :28-31 and the Ewald terms :82-87): each pair vector is the minimum
// image, d - box rint(d / box) (half to even, as torch.round), and the
// pair adds m_j times the Ewald correction of d (ewald.cuh: the trilinear,
// sign-folded lookup of sidm_tpu_torch/ops/ewald.py in the interleaved
// table, eight float4 reads a pair through the read-only cache; 0.57 MB at
// EN = 64, it stays in L2). The self pair adds psi(0) = 2.8372975 / box
// to the potential.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ewald.cuh"
#include "softening.cuh"

namespace {

constexpr int kT = 256;

template <bool POT, bool PBC>
__global__ void __launch_bounds__(kT)
direct_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
              const float* __restrict__ eps, int n,
              const int* __restrict__ targets, int T,
              float* __restrict__ acc, float* __restrict__ pot,
              const EwaldTab ew) {
    __shared__ float4 sp[kT];
    __shared__ float sh[kT];
    const int t = blockIdx.x * kT + threadIdx.x;
    const int i = t < T ? (targets ? __ldg(targets + t) : t) : 0;
    const float xi = __ldg(pos + 3 * (int64_t)i);
    const float yi = __ldg(pos + 3 * (int64_t)i + 1);
    const float zi = __ldg(pos + 3 * (int64_t)i + 2);
    const float hi = 2.8f * __ldg(eps + i);
    double ax = 0.0, ay = 0.0, az = 0.0, ph = 0.0;
    for (int j0 = 0; j0 < n; j0 += kT) {
        const int j = j0 + threadIdx.x;
        if (j < n) {
            sp[threadIdx.x] = make_float4(
                __ldg(pos + 3 * (int64_t)j), __ldg(pos + 3 * (int64_t)j + 1),
                __ldg(pos + 3 * (int64_t)j + 2), __ldg(mass + j));
            sh[threadIdx.x] = 2.8f * __ldg(eps + j);
        } else {
            sp[threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);
            sh[threadIdx.x] = 1.0f;
        }
        __syncthreads();
        float fx = 0.f, fy = 0.f, fz = 0.f, fp = 0.f;
        const int m = min(kT, n - j0);
#pragma unroll 4
        for (int k = 0; k < m; ++k) {
            const float4 s = sp[k];
            float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
            if (PBC) {
                dx -= ew.box * rintf(dx / ew.box);
                dy -= ew.box * rintf(dy / ew.box);
                dz -= ew.box * rintf(dz / ew.box);
            }
            const float r2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
            const float h = fmaxf(hi, sh[k]);
            const float ir = rsqrtf(r2);            // inf for a self pair
            const float r = r2 > 0.0f ? r2 * ir : 0.0f;
            float fac, p;
            if (r >= h) {
                fac = ir * ir * ir;
                p = -ir;
            } else {
                const float hinv = 1.0f / h;
                spline_soft<POT>(r * hinv, hinv, ir, ir * ir * ir, &fac, &p);
            }
            const float f = s.w * fac;
            fx = fmaf(f, dx, fx);
            fy = fmaf(f, dy, fy);
            fz = fmaf(f, dz, fz);
            if (POT) fp = fmaf(s.w, p, fp);
            if (PBC && s.w != 0.0f) {
                float c[4];
                ewald_corr<POT>(dx, dy, dz, ew, c);
                fx = fmaf(s.w, c[0], fx);
                fy = fmaf(s.w, c[1], fy);
                fz = fmaf(s.w, c[2], fz);
                if (POT) fp = fmaf(s.w, c[3], fp);
            }
        }
        ax += fx;
        ay += fy;
        az += fz;
        if (POT) ph += fp;
        __syncthreads();
    }
    if (t < T) {
        acc[3 * (int64_t)t] = (float)ax;
        acc[3 * (int64_t)t + 1] = (float)ay;
        acc[3 * (int64_t)t + 2] = (float)az;
        if (POT) pot[t] = (float)ph;
    }
}

}  // namespace

// pos (n, 3), mass (n,) (0 for padding), eps (n,) float32; targets (T,)
// int32 or null (all n, T = n); outputs acc (T, 3) and, when pot is not
// null, the pair potential sum (T,) without the self term. periodic = 1:
// the minimum image in a box of side box and the interleaved Ewald table
// table4 (M, M, M, 4), M = en / 2 + 1 (ewald.cuh).
extern "C" int direct_launch(const float* pos, const float* mass,
                             const float* eps, int n, const int* targets,
                             int T, float* acc, float* pot,
                             const float* table4, float box, int en,
                             int periodic, void* stream) {
    if (T <= 0) return 0;
    if (periodic && (!table4 || en < 2 || !(box > 0.0f)))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (T + kT - 1) / kT;
    // EN / box as the plain version rounds it (float32 division)
    const EwaldTab e = ewald_tab(table4, box, periodic ? en : 0);
    auto kern = periodic
        ? (pot ? direct_kernel<true, true> : direct_kernel<false, true>)
        : (pot ? direct_kernel<true, false> : direct_kernel<false, false>);
    kern<<<blocks, kT, 0, st>>>(pos, mass, eps, n, targets, T, acc, pot, e);
    return (int)cudaGetLastError();
}
