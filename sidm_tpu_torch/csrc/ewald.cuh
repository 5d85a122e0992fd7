// The Ewald correction of one minimum-image pair vector on the card: the
// lookup of sidm_tpu_torch/ops/ewald.py (EwaldTable.force_correction and
// pot_correction; nbody/ewald.c ewald_corr :171-238 and ewald_pot_corr
// :248-284), shared by the periodic direct sum (direct.cu) and the Ewald
// modes of the walk's far and near passes (far_list.cu, near_kernel.cu).
//
// Per axis |d| EN / box is cut into a cell index, clipped to [0, EN/2 - 1],
// and a fraction; each of the four tables (the force correction per axis
// and the potential correction, (EN/2 + 1)^3 points of the octant) is
// interpolated trilinearly at that cell, the eight corners in the plain
// version's order. The force correction is -sign(d_c) F_c(|d|) (sign(0) =
// 0), the potential's psi(|d|) (psi(0) = 2.8372975 / box at d = 0). The
// tables are interleaved, one float4 (Fx, Fy, Fz, psi) per grid point
// (EwaldTable.table4): a pair reads eight float4 through the read-only
// cache, where four separate tables cost 32 scalar reads. At EN = 64 the
// table is 0.57 MB and stays in L2.
#pragma once

#include <cuda_runtime.h>

struct EwaldTab {
    const float4* t;             // (M, M, M) float4, M = EN / 2 + 1
    float box, scale;            // scale = EN / box, rounded as float32
    int ed;                      // EN / 2
};

__device__ __forceinline__ void ewald_cell(float d, const EwaldTab& ew,
                                           int* i, float* u) {
    const float a = fabsf(d) * ew.scale;
    *i = min(max((int)a, 0), ew.ed - 1);
    *u = a - (float)*i;
}

// The correction of pair vector d = source - target (minimum image) per
// unit source mass: c[0..2] the force's, c[3] (with POT) the potential's.
template <bool POT>
__device__ __forceinline__ void ewald_corr(float dx, float dy, float dz,
                                           const EwaldTab& ew, float* c) {
    const int M = ew.ed + 1;
    int ix, iy, iz;
    float ux, uy, uz;
    ewald_cell(dx, ew, &ix, &ux);
    ewald_cell(dy, ew, &iy, &uy);
    ewald_cell(dz, ew, &iz, &uz);
    float vx = 0.0f, vy = 0.0f, vz = 0.0f, vp = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        const float wx = a ? ux : 1.0f - ux;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
            const float wy = b ? uy : 1.0f - uy;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const float w = wx * wy * (k ? uz : 1.0f - uz);
                const float4 q = __ldg(ew.t + ((ix + a) * M + iy + b) * M
                                       + iz + k);
                vx += w * q.x;
                vy += w * q.y;
                vz += w * q.z;
                if (POT) vp += w * q.w;
            }
        }
    }
    c[0] = -vx * (float)((dx > 0.0f) - (dx < 0.0f));
    c[1] = -vy * (float)((dy > 0.0f) - (dy < 0.0f));
    c[2] = -vz * (float)((dz > 0.0f) - (dz < 0.0f));
    c[3] = POT ? vp : 0.0f;
}

// The host side's table argument: t (M^3 float4), box, EN.
inline EwaldTab ewald_tab(const float* t, float box, int en) {
    return EwaldTab{reinterpret_cast<const float4*>(t), box,
                    en > 0 ? (float)en / box : 0.0f, en / 2};
}
