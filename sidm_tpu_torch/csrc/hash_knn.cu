// H1: the k-th-neighbour radius on the hash grid, every fixed-point
// iteration in one launch. Port of sidm_tpu/ops/neighbors.py:knn_radius
// (:203-229, one iteration :211-223), plain XLA in the JAX package (no
// Pallas original); see sidm_tpu_torch/ops/neighbors.py for the contract.
//
// Per query and iteration: the level of h and its 27 stencil buckets
// (hash_grid.cuh), each read up to cap rows; the same-type rows'
// r^2 = |x_j - x_q|^2 (the minimum image in a periodic box); the k-th
// smallest r^2; h <- sqrt(k-th) * pad when at least k candidates, else
// 2 h. After the last iteration, the count of that iteration's candidates
// with r^2 < h^2. The k-th order statistic does not depend on the order in
// which the candidates come, and every r^2 is rounded as in the plain
// version (-fmad=false), so h and the counts are the plain version's bit
// for bit.
//
// Design: a warp a query. The 27 lanes of the stencil look up their
// buckets and dedupe them by shuffles; a prefix over the capped counts
// flattens (bucket, rank) into one slot range that the 32 lanes stripe,
// so that a bucket's rows are read by neighbouring lanes. The smallest k
// r^2 live in a k-list in shared memory (k <= 128) with its largest value
// as the warp's threshold: a batch of 32 candidates is compared with the
// threshold, and only the lanes below it are inserted, one at a time (each
// insertion replaces the largest and finds the new largest, k/32 loads a
// lane and a shuffle tree). Rows are read from L2/HBM twice in the last
// iteration (its count pass); the earlier iterations' stencils differ.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

using hash_grid::Grid;
using hash_grid::kCells;
using hash_grid::kFull;

constexpr int kWarps = 8;           // queries a block
constexpr int kMaxK = 128;          // the k-list's room

struct WarpShared {
    float klist[kMaxK];
    int pre[kCells + 1];
    int st[kCells];
};

// r^2 of flattened slot t (inf if not a same-type candidate)
__device__ __forceinline__ float slot_r2(const Grid& g, const int* pre,
                                         const int* st, int t, float px,
                                         float py, float pz, int type) {
    const int j = hash_grid::cell_at(pre, t);
    const int e = st[j] + (t - pre[j]);
    const float4 r = __ldg(g.rows + 2 * (int64_t)e);
    const float aux = __ldg(reinterpret_cast<const float*>(g.rows)
                            + 8 * (int64_t)e + 7);
    const float a = aux - floorf(aux / 8.0f) * 8.0f;
    if ((int)a != type) return INFINITY;
    const float d0 = hash_grid::min_image(r.x - px, g.box);
    const float d1 = hash_grid::min_image(r.y - py, g.box);
    const float d2 = hash_grid::min_image(r.z - pz, g.box);
    return d0 * d0 + d1 * d1 + d2 * d2;
}

__global__ void __launch_bounds__(32 * kWarps)
hash_knn_kernel(Grid g, const float* __restrict__ geom,
                const float* __restrict__ pos_q,
                const int* __restrict__ type_q,
                const float* __restrict__ h_guess, int n, int k, int cap,
                int n_iter, float pad, float* __restrict__ h_out,
                int* __restrict__ cnt_out, int* __restrict__ ovf_out,
                int* __restrict__ need_out, int* __restrict__ clip_out,
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
    float h = __ldg(h_guess + q);
    int need = 0, ovf = 0, scanned = 0, total = 0;
    bool clip_any = false;
    for (int it = 0; it < n_iter; ++it) {
        int count, start, key0;
        bool clip;
        hash_grid::stencil(g, px, py, pz, type, h, lane, &count, &start,
                           &key0, &clip);
        clip_any |= clip;
        need = max(need, hash_grid::warp_max(count));
        ovf = __any_sync(kFull, count > cap) ? 1 : 0;
        total = hash_grid::stage_prefix(min(count, cap), lane, start, s.pre,
                                        s.st);
        scanned += total;
        for (int i = lane; i < k; i += 32) s.klist[i] = INFINITY;
        __syncwarp();
        float thr = INFINITY;
        int at = 0, ncand = 0;
        for (int t0 = 0; t0 < total; t0 += 32) {
            const int t = t0 + lane;
            const float r2 = t < total
                ? slot_r2(g, s.pre, s.st, t, px, py, pz, type) : INFINITY;
            ncand += (t < total && r2 != INFINITY) ? 1 : 0;
            unsigned want = __ballot_sync(kFull, r2 < thr);
            while (want) {
                const int src = __ffs(want) - 1;
                want &= want - 1;
                const float x = __shfl_sync(kFull, r2, src);
                if (!(x < thr)) continue;           // uniform
                if (lane == 0) s.klist[at] = x;
                __syncwarp();
                float m = -INFINITY;
                int mp = 0;
                for (int i = lane; i < k; i += 32) {
                    const float v = s.klist[i];
                    if (v > m) { m = v; mp = i; }
                }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    const float om = __shfl_xor_sync(kFull, m, o);
                    const int op = __shfl_xor_sync(kFull, mp, o);
                    if (om > m || (om == m && op < mp)) { m = om; mp = op; }
                }
                thr = m;
                at = mp;
                __syncwarp();
            }
        }
        // a same-type candidate at an infinite distance counts in JAX's
        // mask; none arises from finite positions
        ncand = hash_grid::warp_sum(ncand);
        h = ncand >= k ? sqrtf(fmaxf(thr, 0.0f)) * pad : h * 2.0f;
        if (it + 1 < n_iter) __syncwarp();
    }
    // the last iteration's candidates inside the final h
    const float h2 = h * h;
    int c = 0;
    for (int t = lane; t < total; t += 32) {
        const float r2 = slot_r2(g, s.pre, s.st, t, px, py, pz, type);
        c += (r2 < h2 && isfinite(r2)) ? 1 : 0;
    }
    c = hash_grid::warp_sum(c);
    if (lane == 0) {
        h_out[q] = h;
        cnt_out[q] = c;
        ovf_out[q] = ovf;
        need_out[q] = need;
        clip_out[q] = clip_any ? 1 : 0;
        scanned_out[q] = scanned;
    }
}

}  // namespace

// rows (LN, 8) float32 [pos3 vel3 mass aux] in sorted entry order; bstart,
// bcount (L H,) int32; geom (4,) float32 [origin, s0]; pos_q (n, 3),
// type_q, h_guess (n,); outputs (n,): h, count, overflow (last iteration), need, clip, scanned.
extern "C" int hash_knn_launch(const float* rows, const int* bstart,
                               const int* bcount, const float* geom, int L,
                               int H, float box, const float* pos_q,
                               const int* type_q, const float* h_guess, int n,
                               int k, int cap, int n_iter, float pad,
                               float* h_out, int* cnt_out, int* ovf_out,
                               int* need_out, int* clip_out, int* scanned_out,
                               void* stream) {
    if (n <= 0) return 0;
    if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
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
    hash_knn_kernel<<<blocks, 32 * kWarps, 0, st>>>(
        g, geom, pos_q, type_q, h_guess, n, k, cap, n_iter, pad, h_out,
        cnt_out, ovf_out, need_out, clip_out, scanned_out);
    return (int)cudaGetLastError();
}
