// SIDM candidate emission: every group's targets tested against the
// particles of the group's recorded range segments. Port of
// sidm_tpu/ops/list_range.py:_emit_candidates (:205-317), plain XLA in the
// JAX package (no Pallas original); see sidm_tpu_torch/ops/list_range.py
// for the contract.
//
// One block per target group, one thread per target slot (kG = 64). The
// group's segment keys are read kChunk at a time; their particles
// (start..start+cnt-1, cnt <= 31) are staged in shared memory as float4
// [x y z aux] with their sorted ids, in key order then particle order.
// Each thread then walks the staged particles in that order and appends
// every hit (same type, not itself, r^2 < R^2) to its own candidate row
// while the row has room, counting all hits (the uncapped demand). The
// thread owns its row, so the appends need no atomics and keep JAX's order,
// which decides the K a truncated list keeps. Count mode (the hsml init's
// neighbour count, sidm_tpu/ops/fused_range.py:179-183) counts the
// non-pending hits with sqrt(r^2) < h instead. Products and sums are
// rounded one by one as the plain version rounds them (the file builds
// with -fmad=false), so every decision is the plain version's. With a
// periodic box (box > 0) each difference is taken by the minimum image
// (sidm_pair.cuh). What bounds it on the H100: operations, about 12 per (target, staged particle) pair;
// the staged particles are read once from device memory per group.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sidm_pair.cuh"

namespace {

constexpr int kG = 64;          // targets per group (ops/fused_force.py G)
constexpr int kChunk = 64;      // segment keys staged per round
constexpr int kMaxSeg = 31;     // particles per segment key
constexpr int kImax = 2147483647;

__global__ void __launch_bounds__(kG)
sidm_emit_kernel(const int* __restrict__ keys, const int* __restrict__ nn,
                 int LR, const float4* __restrict__ src,
                 const float* __restrict__ gt, const float* __restrict__ gr,
                 const int* __restrict__ gty, const int* __restrict__ gidx,
                 int K, int count_mode, float box, int* __restrict__ cand,
                 int* __restrict__ ncand, int* __restrict__ needk) {
    __shared__ float4 sp[kChunk * kMaxSeg];
    __shared__ int sj[kChunk * kMaxSeg];
    __shared__ int seg_off[kChunk + 1];
    __shared__ int warp_tot[kG / 32];

    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int slot = g * kG + t;
    const int me = gidx[slot];
    const bool live = me >= 0;
    const float tx = gt[slot * 3 + 0], ty = gt[slot * 3 + 1],
                tz = gt[slot * 3 + 2];
    const float r = gr[slot];
    const float r2max = __fmul_rn(r, r);
    const int typ = gty[slot];
    int* row = (live && !count_mode) ? cand + (int64_t)me * K : nullptr;
    int hits = 0;
    const int nk = min(max(nn[g], 0), LR);
    const int* kg = keys + (int64_t)g * LR;

    for (int c0 = 0; c0 < nk; c0 += kChunk) {
        // this round's keys: counts, then their exclusive prefix sums
        int key = kImax, cnt = 0;
        if (c0 + t < nk) {
            key = kg[c0 + t];
            if (key != kImax) cnt = key & 31;
        }
        int inc = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, inc, o);
            if (lane >= o) inc += y;
        }
        if (lane == 31) warp_tot[warp] = inc;
        __syncthreads();
        const int off = inc - cnt + (warp ? warp_tot[0] : 0);
        seg_off[t] = off;
        if (t == kG - 1) seg_off[kChunk] = off + cnt;
        __syncthreads();
        const int total = seg_off[kChunk];
        // stage: warp w copies the keys w, w + 2, ... (lanes < cnt)
        const int nseg = min(kChunk, nk - c0);
        for (int s = warp; s < nseg; s += kG / 32) {
            const int ks = kg[c0 + s];
            if (ks == kImax) continue;
            const int st = ks >> 5, cs = ks & 31;
            if (lane < cs) {
                sp[seg_off[s] + lane] = __ldg(src + st + lane);
                sj[seg_off[s] + lane] = st + lane;
            }
        }
        __syncthreads();
        if (live) {
            for (int k = 0; k < total; ++k) {
                const float4 q = sp[k];
                const float d0 = sidm_pair::min_image(__fsub_rn(tx, q.x),
                                                      box);
                const float d1 = sidm_pair::min_image(__fsub_rn(ty, q.y),
                                                      box);
                const float d2 = sidm_pair::min_image(__fsub_rn(tz, q.z),
                                                      box);
                const float rr = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0),
                                                     __fmul_rn(d1, d1)),
                                           __fmul_rn(d2, d2));
                const int j = sj[k];
                const int aux = (int)q.w;
                bool hit = ((aux & 7) == typ) && j != me;
                if (count_mode)
                    hit = hit && aux < 8 && __fsqrt_rn(rr) < r;
                else
                    hit = hit && rr < r2max;
                if (hit) {
                    if (row != nullptr && hits < K) row[hits] = j;
                    ++hits;
                }
            }
        }
        __syncthreads();
    }
    if (!live) return;
    if (count_mode) {
        ncand[me] = hits;
        return;
    }
    ncand[me] = min(hits, K);
    needk[me] = hits;
}

}  // namespace

// keys (ng, LR) segment keys with live counts nn; src (n,) float4 [x y z
// aux]; gt (ng, 64, 3), gr/gty/gidx (ng, 64); box the periodic box (0:
// none); cand (n, K) IMAX-filled by
// the caller, ncand/needk (n,) zero-filled (count mode: cand and needk
// null, the counts in ncand).
extern "C" int sidm_emit_launch(const int* keys, const int* nn, int ng,
                                int LR, const float* src, int n,
                                const float* gt, const float* gr,
                                const int* gty, const int* gidx, int K,
                                int count_mode, float box, int* cand,
                                int* ncand,
                                int* needk, void* stream) {
    (void)n;
    if (ng <= 0) return 0;
    sidm_emit_kernel<<<ng, kG, 0, (cudaStream_t)stream>>>(
        keys, nn, LR, reinterpret_cast<const float4*>(src), gt, gr, gty,
        gidx, K, count_mode, box, cand, ncand, needk);
    return (int)cudaGetLastError();
}
