// H4: the velocity-dispersion pass's neighbour sums on the hash grid.
// Port of the sums of sidm_tpu/ops/veldisp.py:veldisp (:57-77), plain XLA
// in the JAX package (no Pallas original); see
// sidm_tpu_torch/ops/veldisp.py:veldisp_sums for the contract.
//
// Per query of radius h (H1's converged radius): the level of h and its 27
// stencil buckets (hash_grid.cuh), each read up to cap rows; a row is a
// neighbour when it has the query's type and r = |x_j - x_q| < max(h,
// 1e-30) (the minimum image in a periodic box); the outputs are the
// neighbour count, sum m W(r/h)/h^3 (W the cubic spline of
// sidm_tpu_torch/kernels.py:sph_kernel), sum v and sum |v|^2, the
// stencil's largest bucket count (need), its level clip and the rows read.
// Every r, W and m W/h^3 term is rounded as in the plain version
// (-fmad=false), so the counts are its own; the terms are summed in
// float64 (<v^2> - <v>^2 cancels in float32), in another order than the
// plain version's.
//
// Design: a warp a query, as in hash_knn.cu: the 27 lanes of the stencil
// look up and dedupe their buckets, a prefix over the capped counts
// flattens (bucket, rank) into one slot range that the 32 lanes stripe
// (a bucket's rows read by neighbouring lanes), each lane keeps its own
// partial sums, and a shuffle tree adds them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

using hash_grid::Grid;
using hash_grid::kCells;
using hash_grid::kFull;

constexpr int kWarps = 8;           // queries a block

struct WarpShared {
    int pre[kCells + 1];
    int st[kCells];
};

// sph_kernel(u): the cubic spline with 8/pi normalisation, 0 for u >= 1,
// each product in the plain version's order
__device__ __forceinline__ float sph_w(float u) {
    const float c = (float)(8.0 / 3.14159265358979323846);
    const float c2 = (float)(2.0 * (8.0 / 3.14159265358979323846));
    const float inner = c * (1.0f - 6.0f * u * u * (1.0f - u));
    const float om = 1.0f - u;
    const float outer = c2 * om * om * om;
    const float w = u < 0.5f ? inner : outer;
    return u < 1.0f ? w : 0.0f;
}

__device__ __forceinline__ double warp_sum_d(double x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    return x;
}

__global__ void __launch_bounds__(32 * kWarps)
hash_veldisp_kernel(Grid g, const float* __restrict__ geom,
                    const float* __restrict__ pos_q,
                    const int* __restrict__ type_q,
                    const float* __restrict__ h_q, int n, int cap,
                    int* __restrict__ cnt_out, double* __restrict__ rho_out,
                    double* __restrict__ sv_out,
                    double* __restrict__ sv2_out, int* __restrict__ need_out,
                    int* __restrict__ clip_out,
                    int* __restrict__ scanned_out) {
    __shared__ WarpShared sh[kWarps];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int q = blockIdx.x * kWarps + w;
    if (q >= n) return;                 // whole warps only
    WarpShared& s = sh[w];
    g.ox = __ldg(geom);
    g.oy = __ldg(geom + 1);
    g.oz = __ldg(geom + 2);
    g.s0 = __ldg(geom + 3);
    const float px = __ldg(pos_q + 3 * (int64_t)q);
    const float py = __ldg(pos_q + 3 * (int64_t)q + 1);
    const float pz = __ldg(pos_q + 3 * (int64_t)q + 2);
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
    const float h3 = hb * hb * hb;
    int c = 0;
    double rho = 0.0, sx = 0.0, sy = 0.0, sz = 0.0, s2 = 0.0;
    for (int t = lane; t < total; t += 32) {
        const int j = hash_grid::cell_at(s.pre, t);
        const int e = s.st[j] + (t - s.pre[j]);
        const float4 b0 = __ldg(g.rows + 2 * (int64_t)e);
        const float4 b1 = __ldg(g.rows + 2 * (int64_t)e + 1);
        const float a = b1.w - floorf(b1.w / 8.0f) * 8.0f;
        if ((int)a != type) continue;
        const float d0 = hash_grid::min_image(b0.x - px, g.box);
        const float d1 = hash_grid::min_image(b0.y - py, g.box);
        const float d2 = hash_grid::min_image(b0.z - pz, g.box);
        const float r = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        if (!(r < hb)) continue;
        const float wk = sph_w(r / hb) / h3;
        rho += (double)(b1.z * wk);
        const double vx = b0.w, vy = b1.x, vz = b1.y;
        sx += vx;
        sy += vy;
        sz += vz;
        s2 += vx * vx + vy * vy + vz * vz;
        ++c;
    }
    c = hash_grid::warp_sum(c);
    rho = warp_sum_d(rho);
    sx = warp_sum_d(sx);
    sy = warp_sum_d(sy);
    sz = warp_sum_d(sz);
    s2 = warp_sum_d(s2);
    if (lane == 0) {
        cnt_out[q] = c;
        rho_out[q] = rho;
        sv_out[3 * (int64_t)q] = sx;
        sv_out[3 * (int64_t)q + 1] = sy;
        sv_out[3 * (int64_t)q + 2] = sz;
        sv2_out[q] = s2;
        need_out[q] = need;
        clip_out[q] = clip ? 1 : 0;
        scanned_out[q] = total;
    }
}

}  // namespace

// rows (LN, 8) float32 [pos3 vel3 mass aux] in sorted entry order; bstart,
// bcount (L H,) int32; geom (4,) float32 [origin, s0]; pos_q (n, 3), type_q,
// h_q (n,); outputs (n,): count, rho (float64), sv (n, 3) and sv2
// (float64), need, clip, rows read.
extern "C" int hash_veldisp_launch(const float* rows, const int* bstart,
                                   const int* bcount, const float* geom,
                                   int L, int H, float box,
                                   const float* pos_q, const int* type_q,
                                   const float* h_q, int n, int cap,
                                   int* cnt_out, double* rho_out,
                                   double* sv_out, double* sv2_out,
                                   int* need_out, int* clip_out,
                                   int* scanned_out, void* stream) {
    if (n <= 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    Grid g;
    g.rows = reinterpret_cast<const float4*>(rows);
    g.bstart = bstart;
    g.bcount = bcount;
    g.ox = g.oy = g.oz = g.s0 = 0.0f;   // read from geom by the kernel
    g.L = L;
    g.H = H;
    g.box = box;
    const int blocks = (n + kWarps - 1) / kWarps;
    hash_veldisp_kernel<<<blocks, 32 * kWarps, 0, st>>>(
        g, geom, pos_q, type_q, h_q, n, cap, cnt_out, rho_out, sv_out,
        sv2_out, need_out, clip_out, scanned_out);
    return (int)cudaGetLastError();
}
