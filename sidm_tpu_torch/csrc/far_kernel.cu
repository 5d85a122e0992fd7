// One walk level: classify + far multipole + key emission, for every
// target group. Port of sidm_tpu/ops/pallas_far.py:_far_kernel (see
// sidm_tpu_torch/ops/far_kernel.py for the contract and the design note).
//
// One thread block (128 threads) per target group loops over the group's
// frontier in chunks of 128 node ids:
//   1. thread k gathers node row fids[g, c0+k] from the level table and
//      classifies it (geometric or relative MAC, BMAX guard, leaf_cap, last
//      level big path), writing the segment/open/big keys in frontier order;
//   2. accepted (far) nodes are compacted into shared memory in frontier
//      order (warp ballots + a 4-warp prefix);
//   3. thread (t, half) accumulates the group-centred monopole + quadrupole
//      sums of every other staged node on target t in registers and folds
//      them into [ax ay az pot] once per chunk (as the TPU kernel does once
//      per item).
// The two halves are added at the end and every group's output row is
// written, so there are no atomics and no uninitialised output.
//
// Record mode (the cached-list walk, sidm_tpu/ops/list_force.py
// _walk_level_keys :160-217) stops after step 1 and writes a fourth plane
// instead of the far field: the flat id lvl_base + local id of every
// accepted node, in frontier order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "far_pair.cuh"

namespace {

constexpr int kG = 64;      // targets per group
constexpr int kWC = 128;    // frontier ids per chunk == threads per block
constexpr int kRow = 16;    // packed node row width (pack_tree)

struct Level {
    const float* tbl;
    int cap, nl_real;
    float theta2, leaf_cap;
    int use_relative, last;
};

struct Class {
    bool far, seg, open, big;
};

// Gather node row `id` (zeros when dead) and classify it against the group
// box: explicit round-to-nearest products and sums, in the order of
// fused_force.classify (no FMA contraction, exact keys).
__device__ __forceinline__ Class classify_row(const Level& L, float s2,
                                              float s4, int id,
                                              float* row, float lo0,
                                              float lo1, float lo2, float hi0,
                                              float hi1, float hi2,
                                              float oac) {
    const bool dead = (id < 0) || (id >= L.nl_real);
#pragma unroll
    for (int k = 0; k < kRow; ++k)
        row[k] = dead ? 0.0f : L.tbl[(int64_t)min(id, L.cap - 1) * kRow + k];
    const float dx0 = fmaxf(fmaxf(lo0 - row[0], row[0] - hi0), 0.0f);
    const float dx1 = fmaxf(fmaxf(lo1 - row[1], row[1] - hi1), 0.0f);
    const float dx2 = fmaxf(fmaxf(lo2 - row[2], row[2] - hi2), 0.0f);
    const float r2b = __fadd_rn(__fadd_rn(__fmul_rn(dx0, dx0),
                                          __fmul_rn(dx1, dx1)),
                                __fmul_rn(dx2, dx2));
    bool mac_open = s2 > __fmul_rn(L.theta2, r2b);
    if (L.use_relative && oac > 0.0f)
        mac_open = __fmul_rn(row[3], s4) >
                   __fmul_rn(__fmul_rn(__fmul_rn(oac, r2b), r2b), r2b);
    mac_open = mac_open || (r2b <= row[15]);
    const float cnt = row[4];
    const bool live = cnt > 0.0f;
    const bool is_leaf = cnt <= L.leaf_cap;
    const bool deep = live && mac_open && !is_leaf;
    return Class{live && !mac_open, live && mac_open && is_leaf,
                 deep && !L.last, deep && L.last};
}

__global__ void __launch_bounds__(kWC)
far_level_kernel(Level L, const float* __restrict__ s_l_ptr,
                 const int* __restrict__ fids,
                 const int* __restrict__ n_live, int W,
                 const float* __restrict__ xc, const float* __restrict__ te,
                 const float* __restrict__ glo, const float* __restrict__ ghi,
                 const float* __restrict__ oac_g, int need_pot, int record,
                 int lvl_base, float* __restrict__ acc,
                 int* __restrict__ segk, int* __restrict__ openk,
                 int* __restrict__ bigk, int* __restrict__ fark) {
    __shared__ float stage[kWC][kStage];
    __shared__ int warp_cnt[kWC / 32];
    __shared__ float red[kG][4];

    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float lo0 = glo[g * 3 + 0], lo1 = glo[g * 3 + 1], lo2 = glo[g * 3 + 2];
    const float hi0 = ghi[g * 3 + 0], hi1 = ghi[g * 3 + 1], hi2 = ghi[g * 3 + 2];
    const float oac = oac_g[g];
    const int nl = min(n_live[g], W);
    const float s_l = *s_l_ptr;
    const float s2 = __fmul_rn(s_l, s_l);
    const float s4 = __fmul_rn(s2, s2);

    if (record) {
        for (int col = tid; col < W; col += kWC) {
            const int id = (col < nl) ? fids[(int64_t)g * W + col] : -1;
            float row[kRow];
            const Class c = classify_row(L, s2, s4, id, row, lo0, lo1, lo2,
                                         hi0, hi1, hi2, oac);
            const int64_t o = (int64_t)g * W + col;
            segk[o] = c.seg ? (int)row[5] * 32 + min((int)row[4], 31)
                            : SIDM_IMAX;
            openk[o] = c.open ? (int)row[6] * 16 + (int)row[7] : SIDM_IMAX;
            bigk[o] = c.big ? id : SIDM_IMAX;
            fark[o] = c.far ? lvl_base + id : SIDM_IMAX;
        }
        return;
    }

    const float gc0 = 0.5f * (lo0 + hi0), gc1 = 0.5f * (lo1 + hi1),
                gc2 = 0.5f * (lo2 + hi2);
    const int t = tid & (kG - 1);
    const int half = tid / kG;
    const float x0 = xc[(g * kG + t) * 3 + 0];
    const float x1 = xc[(g * kG + t) * 3 + 1];
    const float x2 = xc[(g * kG + t) * 3 + 2];
    const float nx2 = x0 * x0 + x1 * x1 + x2 * x2;
    const float tet = te[g * kG + t];
    float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // [ax ay az pot] of this half

    for (int c0 = 0; c0 < W; c0 += kWC) {
        const int col = c0 + tid;
        const int id = (col < nl) ? fids[(int64_t)g * W + col] : -1;
        float row[kRow];
        const Class c = classify_row(L, s2, s4, id, row, lo0, lo1, lo2, hi0,
                                     hi1, hi2, oac);
        if (col < W) {
            const int64_t o = (int64_t)g * W + col;
            segk[o] = c.seg ? (int)row[5] * 32 + min((int)row[4], 31)
                            : SIDM_IMAX;
            openk[o] = c.open ? (int)row[6] * 16 + (int)row[7] : SIDM_IMAX;
            bigk[o] = c.big ? id : SIDM_IMAX;
        }
        // compact the accepted nodes into shared memory, frontier order
        const unsigned ball = __ballot_sync(0xffffffffu, c.far);
        if (lane == 0) warp_cnt[warp] = __popc(ball);
        __syncthreads();
        int off = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kWC / 32; ++w) {
            off += (w < warp) ? warp_cnt[w] : 0;
            total += warp_cnt[w];
        }
        if (c.far)
            far_stage(stage[off + __popc(ball & ((1u << lane) - 1u))], row,
                      gc0, gc1, gc2);
        __syncthreads();
        if (total > 0) {
            FarAcc a = {};
            for (int k = half; k < total; k += 2)
                far_pair(a, stage[k], x0, x1, x2, nx2, tet, need_pot);
            far_combine(out, a, x0, x1, x2);
        }
        __syncthreads();
    }

    // the two halves of each target: half 1 hands its sums to half 0
    if (half == 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) red[t][k] = out[k];
    }
    __syncthreads();
    if (half == 0) {
        float* dst = acc + ((int64_t)g * kG + t) * 4;
#pragma unroll
        for (int k = 0; k < 3; ++k) dst[k] = out[k] + red[t][k];
        dst[3] = need_pot ? out[3] + red[t][3] : 0.0f;
    }
}

}  // namespace

// record != 0: classification and keys only (fark receives the far keys;
// xc, te and acc are not read or written and may be null).
extern "C" int far_level_launch(const float* tbl, int cap, int nl_real,
                                const int* fids, const int* n_live, int ng,
                                int W, const float* s_l, const float* xc,
                                const float* te, const float* glo,
                                const float* ghi, const float* oac,
                                float theta2, int use_relative,
                                float leaf_cap, int last, int need_pot,
                                int record, int lvl_base, float* acc,
                                int* segk, int* openk, int* bigk, int* fark,
                                void* stream) {
    if (ng > 0) {
        const Level L{tbl, cap, nl_real, theta2, leaf_cap, use_relative,
                      last};
        far_level_kernel<<<ng, kWC, 0, (cudaStream_t)stream>>>(
            L, s_l, fids, n_live, W, xc, te, glo, ghi, oac, need_pot, record,
            lvl_base, acc, segk, openk, bigk, fark);
    }
    return (int)cudaGetLastError();
}
