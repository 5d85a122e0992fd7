// The gated DSMC tile: per gated target over its cached candidates, the
// kernel-weighted pair probabilities, their sum, the neighbour count and
// the Gumbel-max partner. Port of the tile of
// sidm_tpu/ops/list_range.py:_eval_gated (:434-484), plain XLA in the JAX
// package (no Pallas original); see sidm_tpu_torch/ops/list_range.py for
// the contract.
//
// One warp per target of the compacted target list (tid, -1 = unused);
// lane l takes the candidates l, l + 32, ... below the target's ncand (no
// padding to K). Per pair: r = |x_i - x_j|, ok = r < h and the partner has
// no pending kick; P_j = 0.5 m_j W(r/h)/h^3 sigma(v) v dt; the key
// log(max(P_j, 1e-37)) + Gumbel(i, j, salt) for P_j > 0. The lanes' sums,
// counts and (key, id) maxima are combined by a fixed shuffle tree, the
// larger sorted id winning on equal keys as JAX's max over
// where(key == max, j, -1) does. The pair arithmetic is the plain
// version's, rounded one operation at a time (the file builds with
// -fmad=false), so the keys match it bit for bit; the sum is taken in
// another order (float32 rounding). With a periodic box (box > 0) each
// difference is taken by the minimum image. The pair math lives in
// sidm_pair.cuh, shared with the walk's segment pass. What bounds it on
// the H100: bytes, the candidate ids and the candidates' 32-byte rows
// gathered.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sidm_pair.cuh"

namespace {

using sidm_pair::min_image;
using sidm_pair::pair_key;
using sidm_pair::pair_prob;
using sidm_pair::Sigma;

constexpr int kWarps = 8;
constexpr int kImax = 2147483647;

__global__ void __launch_bounds__(kWarps * 32)
sidm_gated_kernel(const float4* __restrict__ rows, const int* __restrict__ cand,
                  int n, int K, const int* __restrict__ ncand,
                  const float* __restrict__ hs, const float* __restrict__ dts,
                  const int* __restrict__ tid, int T, uint32_t salt,
                  Sigma sigma, float box, float* __restrict__ ptot,
                  int* __restrict__ cnt, float* __restrict__ bestk,
                  int* __restrict__ bestj) {
    const int lane = threadIdx.x & 31;
    const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (w >= T) return;
    const int i = tid[w];
    if (i < 0) return;                      // the whole warp leaves
    const int nc = min(ncand[i], K);
    const float th = hs[i], tdt = dts[i];
    const float4 a0 = __ldg(rows + (int64_t)i * 2);
    const float4 a1 = __ldg(rows + (int64_t)i * 2 + 1);
    const float h = fmaxf(th, 1e-30f);
    const float h3 = h * h * h;
    const int* ci = cand + (int64_t)i * K;
    float psum = 0.0f, bk = -INFINITY;
    int cn = 0, bj = -1;
    for (int c = lane; c < nc; c += 32) {
        const int cj = ci[c];
        if (cj == kImax) continue;
        const int j = min(max(cj, 0), n - 1);
        const float4 b0 = __ldg(rows + (int64_t)j * 2);
        const float4 b1 = __ldg(rows + (int64_t)j * 2 + 1);
        const float d0 = min_image(a0.x - b0.x, box);
        const float d1 = min_image(a0.y - b0.y, box);
        const float d2 = min_image(a0.z - b0.z, box);
        const float r = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        if (!(r < th) || b1.w >= 8.0f) continue;
        ++cn;
        const float prob = pair_prob(r, h, h3, a0.w - b0.w, a1.x - b1.x,
                                     a1.y - b1.y, b1.z, tdt, sigma);
        psum += prob;
        if (prob > 0.0f) {
            const float key = pair_key(prob, (uint32_t)i, (uint32_t)j, salt);
            if (key > bk || (key == bk && j > bj)) {
                bk = key;
                bj = j;
            }
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
        cn += __shfl_xor_sync(0xffffffffu, cn, o);
        const float ok = __shfl_xor_sync(0xffffffffu, bk, o);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
        if (ok > bk || (ok == bk && oj > bj)) {
            bk = ok;
            bj = oj;
        }
    }
    if (lane == 0) {
        ptot[i] = psum;
        cnt[i] = cn;
        bestk[i] = bk;
        bestj[i] = isfinite(bk) ? bj : -1;
    }
}

}  // namespace

// rows (n, 8) float32 sorted [pos3 vel3 mass aux]; cand (n, K) with live
// counts ncand; hs, dts (n,); tid (T,) target ids, -1 = unused; box the
// periodic box (0: none); outputs
// (n,) prefilled by the caller (0, 0, -inf, -1) and written at the
// targets.
extern "C" int sidm_gated_launch(const float* rows, const int* cand, int n,
                                 int K, const int* ncand, const float* hs,
                                 const float* dts, const int* tid, int T,
                                 unsigned salt, int cs_type, float sigma_co,
                                 float vc, float vel_scale, float pow_law,
                                 float box, float* ptot, int* cnt,
                                 float* bestk,
                                 int* bestj, void* stream) {
    if (T <= 0) return 0;
    const Sigma sigma{cs_type, sigma_co, vc, vel_scale, pow_law};
    sidm_gated_kernel<<<(T + kWarps - 1) / kWarps, kWarps * 32, 0,
                        (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), cand, n, K, ncand, hs, dts,
        tid, T, (uint32_t)salt, sigma, box, ptot, cnt, bestk, bestj);
    return (int)cudaGetLastError();
}
